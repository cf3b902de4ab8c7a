"""Paged decode attention on the H100: wrappers of ``csrc/decode_attention.cu``.

One kernel body, four entry points, each replacing a Pallas body of
``repro/kernels/decode_attention.py``:

  * `paged_decode_attention`: ``paged_decode_attention_kernel_call``
    (``_decode_kernel``), bf16 rows of a per-slot cache (B, S, KH, d).  The
    serving path: every layer of every decode step calls it once
    (``models/transformer.py::decode_step_paged``).
  * `paged_decode_attention_q8`: the same call with ``k_scale``/``v_scale``
    (``_decode_kernel_q``): int8 rows, one f32 scale a (row, KV head)
    (``models/quant.quantize_kv``), widened on read.
  * `paged_decode_attention_bt`: ``paged_decode_attention_bt_kernel_call``
    (``_decode_kernel_bt``): a pooled cache (NB, bs, KH, d) read through
    per-slot block tables (B, nb); ``decode_step_paged(tables=)``.
  * `paged_decode_attention_bt_q8`: the pooled call with scales
    (``_decode_kernel_bt_q``), int8 pool + (NB, bs, KH) scales.

Bound on the H100: bytes.  A slot's valid K/V rows are read once each and
serve G query heads, about 2*G flops per byte of bf16 (4*G of int8, whose
rows are half the bytes plus a 4-byte scale a row and KV head; the pooled
calls also read the tables).  The kernel splits each (slot, KV head) into
chunks of a fixed number of logical rows, one block a chunk, reads only
logical rows ``< seq_lens[b]`` (and inside the window) straight into
registers, keeps the online softmax in f32 registers, and lets the last
block of each (slot, KV head) combine the chunks' partials in chunk order
within the same launch.  The partials and the counters that find the last
block live in a workspace that `_workspace` allocates once per device and
stream and reuses (the kernel leaves the counters at zero).  A pooled
launch finds each row through the slot's table and otherwise does what a
per-slot launch does, so it computes the same bits as the per-slot launch
on the gathered view (bf16 and int8 alike).  See the source for the
design and what is left.

Each wrapper launches the kernel on CUDA tensors and raises on anything it
does not take; ``ops`` sends CPU tensors to the plain versions in ``ref``.
``launches``, ``launches_q``, ``launches_bt`` and ``launches_bt_q`` count
the successful launches of each.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from repro_torch.kernels import build

SUPPORTED_HEAD_DIMS = (16, 64, 128)
MAX_GD = 1024          # largest (H / KH) * head_dim the kernel takes

launches = 0           # per-slot bf16 launches in this process
launches_q = 0         # per-slot int8 launches
launches_bt = 0        # pooled bf16 launches
launches_bt_q = 0      # pooled int8 launches


def _check(q, k, v, seq_lens, kv_dtype, k_scale=None, v_scale=None,
           tables=None):
    """Raise unless the kernel takes these inputs; returns (B, H, d)."""
    build.check_tensor("q", q, torch.bfloat16, 3)
    build.check_tensor("k", k, kv_dtype, 4)
    build.check_tensor("v", v, kv_dtype, 4)
    build.check_tensor("seq_lens", seq_lens, torch.int32, 1, align=4)
    B, H, d = q.shape
    if k.shape[3] != d or v.shape != k.shape:
        layout = "(NB, bs, KH, d)" if tables is not None else "(B, S, KH, d)"
        raise ValueError(f"k, v must be {layout} with d = {d}, got "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if tables is None and k.shape[0] != B:
        raise ValueError(f"k, v must be (B, S, KH, d) with B = {B}, got "
                         f"{tuple(k.shape)}")
    if seq_lens.shape[0] != B:
        raise ValueError(f"seq_lens must be ({B},), got {tuple(seq_lens.shape)}")
    ts = [q, k, v, seq_lens]
    if k_scale is not None:
        for name, s in (("k_scale", k_scale), ("v_scale", v_scale)):
            build.check_tensor(name, s, torch.float32, 3, align=4)
            if s.shape != k.shape[:3]:
                raise ValueError(f"{name} must be {tuple(k.shape[:3])} (one "
                                 f"scale a row and KV head), got "
                                 f"{tuple(s.shape)}")
        ts += [k_scale, v_scale]
    if tables is not None:
        build.check_tensor("tables", tables, torch.int32, 2, align=4)
        if tables.shape[0] != B or not tables.shape[1]:
            raise ValueError(f"tables must be ({B}, nb) with nb >= 1, got "
                             f"{tuple(tables.shape)}")
        ts.append(tables)
    if len({t.device for t in ts}) != 1:
        raise ValueError("q, k, v, seq_lens, scales and tables must be on "
                         "one device")
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head_dim {d} not in {SUPPORTED_HEAD_DIMS}")
    KH = k.shape[2]
    if H % KH or (H // KH) * d > MAX_GD:
        raise ValueError(f"need H % KH == 0 and (H/KH)*d <= {MAX_GD}; "
                         f"H={H} KH={KH} d={d}")
    return B, H, d


def _options(d, window, softcap, scale):
    return (-1 if window is None else int(window),
            0.0 if softcap is None else float(softcap),
            d ** -0.5 if scale is None else float(scale))


_workspaces = {}       # (device, stream) -> (partials f32, counters int32)


@functools.lru_cache(maxsize=None)
def _partials(B, H, KH, S, d):
    """Floats of the partials a launch of this shape needs."""
    return build.library().repro_decode_attention_partials(B, H, KH, S, d)


def _workspace(q, B, H, KH, S, d, stream):
    """The kernel's workspace for this launch: partials (f32, as many as
    ``repro_decode_attention_partials`` asks) and B * H counters (int32,
    zero; the kernel leaves them zero).  Cached per device and stream,
    grown when a launch needs more; launches on one stream run in order,
    so they may share it."""
    need = _partials(B, H, KH, S, d)
    if need < 0:
        raise ValueError(f"no decode workspace for B={B} H={H} KH={KH}")
    key = (q.device, stream)
    part, count = _workspaces.get(key, (None, None))
    if part is None or part.numel() < need:
        part = torch.empty(need, dtype=torch.float32, device=q.device)
    if count is None or count.numel() < B * H:
        count = torch.zeros(B * H, dtype=torch.int32, device=q.device)
    _workspaces[key] = (part, count)
    return part, count


def _launch(name, q, tensors, dims, options, S):
    """Call C entry point ``name`` as (tensors' pointers, out, workspace,
    dims, options, stream) on q's device and stream; dims start (B, H, KH)
    and S is the logical rows a slot can hold.  Returns ``out``."""
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        part, count = _workspace(q, *dims[:3], S, q.shape[2], stream)
        err = getattr(build.library(), name)(
            *[t.data_ptr() for t in tensors], out.data_ptr(),
            part.data_ptr(), count.data_ptr(), *dims, *options, stream)
    build.check(err, name)
    return out


def paged_decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           seq_lens: torch.Tensor, *,
                           window: Optional[int] = None,
                           softcap: Optional[float] = None,
                           scale: Optional[float] = None) -> torch.Tensor:
    """q (B, H, d) bf16; k, v (B, S, KH, d) bf16; seq_lens (B,) int32 on the
    card (valid rows per slot, the just-written token included; at most S)
    -> (B, H, d) bf16.  Launched on the current stream."""
    global launches
    B, H, d = _check(q, k, v, seq_lens, torch.bfloat16)
    S, KH = k.shape[1], k.shape[2]
    out = _launch("repro_decode_attention_bf16", q, (q, k, v, seq_lens),
                  (B, H, KH, S, d), _options(d, window, softcap, scale), S)
    launches += 1
    return out


def paged_decode_attention_q8(q, k, k_scale, v, v_scale, seq_lens, *,
                              window: Optional[int] = None,
                              softcap: Optional[float] = None,
                              scale: Optional[float] = None) -> torch.Tensor:
    """`paged_decode_attention` over int8 rows: k, v (B, S, KH, d) int8;
    k_scale, v_scale (B, S, KH) f32 (``quant.quantize_kv``); each element
    is ``x * scale`` in f32 where it is used -> (B, H, d) bf16."""
    global launches_q
    B, H, d = _check(q, k, v, seq_lens, torch.int8, k_scale, v_scale)
    S, KH = k.shape[1], k.shape[2]
    out = _launch("repro_decode_attention_q8", q,
                  (q, k, k_scale, v, v_scale, seq_lens), (B, H, KH, S, d),
                  _options(d, window, softcap, scale), S)
    launches_q += 1
    return out


def paged_decode_attention_bt(q, k, v, seq_lens, tables, *,
                              window: Optional[int] = None,
                              softcap: Optional[float] = None,
                              scale: Optional[float] = None) -> torch.Tensor:
    """q (B, H, d) bf16; k, v (NB, bs, KH, d) bf16 block pool; seq_lens (B,)
    int32 valid LOGICAL rows per slot (at most nb * bs); tables (B, nb)
    int32: logical block j of slot b is pool block ``tables[b, j]``, an
    entry outside [0, NB) reads the nearest pool block (its lanes lie past
    seq_len in every caller) -> (B, H, d) bf16."""
    global launches_bt
    B, H, d = _check(q, k, v, seq_lens, torch.bfloat16, tables=tables)
    NB, bs, KH = k.shape[:3]
    out = _launch("repro_decode_attention_bt_bf16", q,
                  (q, k, v, seq_lens, tables),
                  (B, H, KH, NB, bs, tables.shape[1], d),
                  _options(d, window, softcap, scale), tables.shape[1] * bs)
    launches_bt += 1
    return out


def paged_decode_attention_bt_q8(q, k, k_scale, v, v_scale, seq_lens,
                                 tables, *, window: Optional[int] = None,
                                 softcap: Optional[float] = None,
                                 scale: Optional[float] = None
                                 ) -> torch.Tensor:
    """`paged_decode_attention_bt` over an int8 pool: k, v (NB, bs, KH, d)
    int8; k_scale, v_scale (NB, bs, KH) f32 -> (B, H, d) bf16."""
    global launches_bt_q
    B, H, d = _check(q, k, v, seq_lens, torch.int8, k_scale, v_scale,
                     tables)
    NB, bs, KH = k.shape[:3]
    out = _launch("repro_decode_attention_bt_q8", q,
                  (q, k, k_scale, v, v_scale, seq_lens, tables),
                  (B, H, KH, NB, bs, tables.shape[1], d),
                  _options(d, window, softcap, scale), tables.shape[1] * bs)
    launches_bt_q += 1
    return out
