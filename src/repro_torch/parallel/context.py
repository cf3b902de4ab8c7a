"""ParallelContext — the bridge between model code and the ranks.

Port of ``repro/parallel/context.py``.  The reference binds axis names to
a jax ``Mesh`` and lets ``shard_map`` place the collectives.  The port
binds them to a ``torch.distributed.device_mesh.DeviceMesh`` over the
initialised default process group (``launch/mesh.make_mesh``): one
process a rank, ranks row-major over the mesh, so rank (d, m) of a
(data, model) mesh is global rank ``d * model_size + m``.  Model code
reads the axis sizes, the rank's coordinate on an axis (the reference's
``axis_index``) and the process group of an axis, and runs the
collectives through this module's transport.

``mesh=None`` (``LOCAL``), or a mesh whose axes all have size 1, is one
device: every path computes locally, as the reference's does.

Transport.  Each collective takes and returns tensors on the rank's
device.  NCCL takes CUDA tensors, gloo CPU tensors as they are.  Where a
gloo group meets CUDA tensors (several ranks sharing one card, where
NCCL refuses two ranks a GPU), the collective stages them through pinned
host buffers: copied to the host, exchanged by gloo, copied back to the
card.  That is the transport of that pairing, chosen by backend and
device, never by catching an error.  ``wire_bytes`` adds, for each
collective, the bytes a bandwidth-optimal algorithm sends from this rank:
(s - 1) / s of an all-to-all's input, 2 (s - 1) / s of an all-reduce's,
(s - 1) times an all-gather's, over a group of s ranks.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

# bytes this process sent through the collectives below (see the module doc)
wire_bytes = 0

STAGE_CHUNK = 1 << 26        # elements a staged in-place all-reduce moves at once


@dataclass(frozen=True)
class ParallelContext:
    mesh: Optional[Any] = None          # torch.distributed DeviceMesh
    data_axis: Optional[str] = "data"
    model_axis: Optional[str] = "model"
    # SparseCore engine knobs (the reference's): bf16 embedding vectors on
    # the wire, all-to-all send capacity factor, method override, and the
    # pipelined multi-group executor (False = one exchange a group in turn)
    emb_wire_bf16: bool = False
    emb_capacity_factor: float = 2.0
    emb_method: str = "auto"
    emb_pipeline: bool = True

    def axis_size(self, name: Optional[str]) -> int:
        if name is None or self.mesh is None:
            return 1
        names = self.mesh.mesh_dim_names or ()
        if name not in names:
            return 1
        return self.mesh.size(names.index(name))

    @property
    def batch_axes(self) -> Tuple[str, ...]:
        """Mesh axes the global batch is sharded over."""
        return tuple(a for a in (self.data_axis,)
                     if a is not None and self.axis_size(a) > 1)

    @property
    def model_axis_size(self) -> int:
        return self.axis_size(self.model_axis)

    @property
    def has_mesh(self) -> bool:
        return self.mesh is not None and any(
            s > 1 for s in self.mesh.mesh.shape)

    def axis_index(self, name: Optional[str]) -> int:
        """This rank's coordinate on axis ``name`` (0 off the mesh)."""
        if self.axis_size(name) <= 1:
            return 0
        return self.mesh.get_local_rank(name)

    def group(self, name: Optional[str] = None):
        """The process group of axis ``name``; ``None``: every rank."""
        if name is None:
            return dist.group.WORLD
        return self.mesh.get_group(name)

    # -- the batch: split over (data, model) in rank order ------------------

    @property
    def batch_shards(self) -> int:
        """Pieces the sparse stage splits the global batch into: the data
        axis times the model axis (the reference's ``P(batch_both)``)."""
        return self.axis_size(self.data_axis) * self.model_axis_size

    @property
    def batch_index(self) -> int:
        """Which of those pieces this rank holds: d * model_size + m."""
        return (self.axis_index(self.data_axis) * self.model_axis_size
                + self.axis_index(self.model_axis))

    def local_rows(self, n: int) -> slice:
        """This rank's rows of a global batch of ``n`` samples."""
        if n % self.batch_shards:
            raise ValueError(f"batch {n} does not split over "
                             f"{self.batch_shards} ranks")
        b = n // self.batch_shards
        return slice(self.batch_index * b, (self.batch_index + 1) * b)

    # -- collectives over an axis -------------------------------------------

    def all_to_all(self, x: torch.Tensor, axis: str, *,
                   async_op: bool = False, splits=None):
        """All-to-all over dim 0 of ``x`` within the axis: block j goes to
        the rank at coordinate j, and block j of the result came from it.
        Equal blocks (``x``: (axis-size, ...)), or with ``splits`` =
        (rows sent to each coordinate, rows received from each) blocks of
        those lengths (the variable-length exchange)."""
        return all_to_all(x, self.group(axis), async_op=async_op,
                          splits=splits)

    def all_reduce(self, x: torch.Tensor, axis: Optional[str] = None, *,
                   async_op: bool = False, op: str = "sum"):
        """Sum (``op="max"``: the largest) of ``x`` over the axis
        (``None``: every rank), a new tensor."""
        return all_reduce(x, self.group(axis), async_op=async_op, op=op)

    def all_gather(self, x: torch.Tensor, axis: Optional[str] = None
                   ) -> torch.Tensor:
        """The axis's ``x`` concatenated over dim 0 in coordinate order."""
        return all_gather(x, self.group(axis))

    def all_reduce_(self, x: torch.Tensor, axis: Optional[str] = None
                    ) -> torch.Tensor:
        """Sum of ``x`` over the axis, written into ``x``."""
        return all_reduce_(x, self.group(axis))


LOCAL = ParallelContext()


# ---------------------------------------------------------------------------
# Transport
# ---------------------------------------------------------------------------

# free pinned host buffers by (elements, dtype), elements a power of two
_PINNED: Dict[Tuple[int, torch.dtype], List[torch.Tensor]] = {}


def _take(shape, dtype) -> torch.Tensor:
    """A pinned host tensor of ``shape``: a view of a pooled buffer whose
    size is the next power of two, so exchanges of varying length reuse
    a few buffers."""
    n = 1
    for d in shape:
        n *= d
    size = 1 << max(16, (n - 1).bit_length())
    free = _PINNED.get((size, dtype))
    buf = free.pop() if free else torch.empty(size, dtype=dtype,
                                              pin_memory=True)
    return buf[:n].view(tuple(shape))


def _give(*views: torch.Tensor) -> None:
    for v in views:
        buf = v._base if v._base is not None else v
        _PINNED.setdefault((buf.numel(), buf.dtype), []).append(buf)


def _staged(x: torch.Tensor, group) -> bool:
    """gloo with CUDA tensors: stage through pinned host buffers."""
    return x.is_cuda and dist.get_backend(group) == "gloo"


def _count(nbytes: float) -> None:
    global wire_bytes
    wire_bytes += int(nbytes)


class Pending:
    """A collective in flight: ``wait()`` returns its result on the
    device of the tensor it was given."""

    def __init__(self, work, out: torch.Tensor,
                 finish: Optional[Callable[[torch.Tensor], torch.Tensor]]
                 = None):
        self.work, self.out, self.finish = work, out, finish

    def wait(self) -> torch.Tensor:
        if self.work is not None:
            self.work.wait()
        out = self.out if self.finish is None else self.finish(self.out)
        self.work = self.finish = None
        self.out = out
        return out

    def then(self, fn: Callable[[torch.Tensor], torch.Tensor]) -> "Pending":
        """A handle whose ``wait()`` is ``fn`` of this one's."""
        return Pending(None, self, lambda p: fn(p.wait()))


def _to_device(device, *bufs):
    def finish(host):
        out = host.to(device)
        _give(*bufs)
        return out
    return finish


def all_to_all(x: torch.Tensor, group, *, async_op: bool = False,
               splits=None):
    """All-to-all of ``x`` over dim 0 within ``group``: equal blocks, or
    ``splits`` = (rows sent to each rank, rows received from each)."""
    s = dist.get_world_size(group)
    x = x.contiguous()
    row = x[0].numel() * x.element_size() if x.shape[0] else 0
    if splits is None:
        shape, kw = x.shape, {}
        _count(x.numel() * x.element_size() * (s - 1) / s)
    else:
        sent, got = (list(map(int, v)) for v in splits)
        shape = (sum(got), *x.shape[1:])
        kw = dict(input_split_sizes=sent, output_split_sizes=got)
        _count((sum(sent) - sent[dist.get_rank(group)]) * row)
    if _staged(x, group):
        hin, hout = _take(x.shape, x.dtype), _take(shape, x.dtype)
        hin.copy_(x)
        work = dist.all_to_all_single(hout, hin, group=group, async_op=True,
                                      **kw)
        p = Pending(work, hout, _to_device(x.device, hin, hout))
    else:
        out = torch.empty(shape, dtype=x.dtype, device=x.device)
        work = dist.all_to_all_single(out, x, group=group, async_op=True,
                                      **kw)
        p = Pending(work, out)
    return p if async_op else p.wait()


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def all_reduce(x: torch.Tensor, group, *, async_op: bool = False,
               op: str = "sum"):
    """Sum (``op="max"``: the largest) of ``x`` over ``group``, a new
    tensor."""
    s = dist.get_world_size(group)
    _count(x.numel() * x.element_size() * 2 * (s - 1) / s)
    if _staged(x, group):
        h = _take(x.shape, x.dtype)
        h.copy_(x)
        work = dist.all_reduce(h, op=_OPS[op], group=group, async_op=True)
        p = Pending(work, h, _to_device(x.device, h))
    else:
        out = x.clone(memory_format=torch.contiguous_format)
        work = dist.all_reduce(out, op=_OPS[op], group=group, async_op=True)
        p = Pending(work, out)
    return p if async_op else p.wait()


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` of every rank of ``group`` concatenated over dim 0, in rank
    order within the group."""
    s = dist.get_world_size(group)
    x = x.contiguous()
    _count(x.numel() * x.element_size() * (s - 1))
    if _staged(x, group):
        hin = _take(x.shape, x.dtype)
        hin.copy_(x)
        outs = [_take(x.shape, x.dtype) for _ in range(s)]
        dist.all_gather(outs, hin, group=group)
        out = torch.cat(outs).to(x.device)
        _give(hin, *outs)
        return out
    outs = [torch.empty_like(x) for _ in range(s)]
    dist.all_gather(outs, x, group=group)
    return torch.cat(outs)


def all_reduce_(x: torch.Tensor, group) -> torch.Tensor:
    """Sum of ``x`` over ``group`` in place (a gradient).  Where gloo meets
    CUDA tensors, staged in blocks of `STAGE_CHUNK` elements: block i+1
    is copied to the host while block i is reduced, and block i copied
    back while block i+1 is."""
    s = dist.get_world_size(group)
    if s == 1:
        return x
    _count(x.numel() * x.element_size() * 2 * (s - 1) / s)
    if not _staged(x, group):
        dist.all_reduce(x, group=group)
        return x
    flat = x.view(-1)
    prev = None
    for i in range(0, flat.numel() + STAGE_CHUNK, STAGE_CHUNK):
        cur = None
        if i < flat.numel():
            part = flat[i:i + STAGE_CHUNK]
            h = _take(part.shape, part.dtype)
            h.copy_(part)
            cur = (part, h, dist.all_reduce(h, group=group, async_op=True))
        if prev is not None:
            part, h, work = prev
            work.wait()
            part.copy_(h)
            _give(h)
        prev = cur
    return x


class _Exchanged(torch.autograd.Function):
    """Links the tensor a collective was given to the one it returned:
    forward waits for the pending result, backward runs ``back`` on the
    incoming gradient (the collective's transpose)."""

    @staticmethod
    def forward(ctx, x, pending, back):
        ctx.back = back
        return pending.wait()

    @staticmethod
    def backward(ctx, g):
        return ctx.back(g.contiguous()), None, None


def exchanged(x: torch.Tensor, pending: Pending,
              back: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
    """The result of ``pending`` (a collective started on ``x``'s values),
    differentiable with respect to ``x`` through ``back``."""
    return _Exchanged.apply(x, pending, back)
