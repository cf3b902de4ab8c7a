"""Fused multi-table embedding gradient scatter on the H100: wrapper of
``csrc/fused_scatter.cu``.

Replaces the Pallas ``repro/kernels/embedding_grad.py::
fused_scatter_kernel_call`` (body ``_fused_scatter_kernel``): the backward
of the fused lookup (``ops.FusedLookup``, the port's counterpart of the
reference's ``ops.fused_lookup`` ``custom_vjp``), launched once a train
step over every table.

Bound on the H100: bytes.  The gradient is dense, as in the reference: a
zeroed (R_g, D_g) f32 buffer for every row space, as large as the tables;
the kernels read each valid descriptor's D_g lanes of the slot gradient
once and write each touched row once.  Rows repeat (Zipf ids), so the
sum is made deterministic: the descriptors are ordered by (row space,
row) with a stable sort of one key each, ``first_g + row`` (`key_firsts`;
int32 where the rows of all row spaces fit, else int64), and each run
is summed in f32 registers in the reference's (b, s) order: the runs of
fewer than `HOT_RUN` descriptors by the run kernel, several at once a
warp, the hot runs by a second launch that splits each run's lanes (never
its descriptors: the bits depend on it) over blocks.  Two launches on the
same inputs give the same bits.  See the source for the design.

`fused_scatter` launches on CUDA tensors and raises on anything it does
not take; ``ops`` sends CPU tensors to the plain version in ``ref``.
`order_descriptors` and `reduce_runs` are its two halves, and
`reduce_short_runs` and `reduce_hot_runs` the two launches of the
second, public so that ``chip_smoke.py`` can time each alone;
`hot_items` reads the hot list that passes between them.
`descriptor_keys` and `split_keys` are the plain versions of the key
kernel and of the run kernels' key decoding.  Each counter adds one where
its kernel is launched: ``launches_keys`` the key kernel, ``launches`` the
run kernel (so one a `reduce_runs` call and one a `fused_scatter` call),
``launches_hot`` the hot-run kernel.
"""
from __future__ import annotations

import ctypes
import itertools
from typing import List, Sequence, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.fused_lookup import MAX_DIM, MAX_GROUPS

launches = 0           # run-kernel launches (one a `reduce_runs` call)
launches_hot = 0       # hot-run-kernel launches
launches_keys = 0      # key-kernel launches
# descriptors from which a run goes to the hot list: HOT_MIN in the source
HOT_RUN = 512
KEY32_NONE = 2 ** 31 - 1   # int32 key of an invalid descriptor (sorts last)
KEY64_NONE = 2 ** 63 - 1   # int64 key of an invalid descriptor


def _check(gout, rows, slots, col_slot, shapes) -> List[Tuple[int, int]]:
    shapes = [(int(r), int(d)) for r, d in shapes]
    if not 0 < len(shapes) <= MAX_GROUPS:
        raise ValueError(f"need 1..{MAX_GROUPS} row spaces, got {len(shapes)}")
    build.check_tensor("gout", gout, torch.float32, 3)
    build.check_tensor("rows", rows, torch.int32, 2, align=4)
    build.check_tensor("slots", slots, torch.int32, 2)
    build.check_tensor("col_slot", col_slot, torch.int32, 1, align=4)
    B, K, dmax = gout.shape
    if slots.shape != (K, 4):
        raise ValueError(f"slots must be (K, 4) with K = {K}, got "
                         f"{tuple(slots.shape)}")
    if col_slot.shape != rows.shape[1:]:
        raise ValueError(f"col_slot must be (S,) with S = {rows.shape[1]}, "
                         f"got {tuple(col_slot.shape)}")
    if rows.shape[0] != B:
        raise ValueError(f"rows {tuple(rows.shape)} and gout "
                         f"{tuple(gout.shape)} disagree on B")
    if dmax % 4 or not 0 < dmax <= MAX_DIM:
        raise ValueError(f"dmax {dmax}: need a multiple of 4 in "
                         f"[4, {MAX_DIM}]")
    for i, (R, D) in enumerate(shapes):
        if D % 4 or not 0 < D <= dmax or R <= 0:
            raise ValueError(f"row space {i} ({R}, {D}): need rows >= 1 and "
                             f"a dim that is a multiple of 4, <= {dmax}")
        if R >= 2 ** 31:
            raise ValueError(f"row space {i} has {R} rows; int32 row ids "
                             f"address at most 2^31 - 1")
    if len({gout.device, rows.device, slots.device, col_slot.device}) != 1:
        raise ValueError("gout, rows, slots and col_slot must be on one "
                         "device")
    return shapes


def key_firsts(shapes: Sequence[Tuple[int, int]]) -> List[int]:
    """The key of row 0 of each row space: the sum of the rows of the row
    spaces before it.  The key of row r of row space g is ``first_g + r``."""
    return list(itertools.accumulate((int(r) for r, _ in shapes[:-1]),
                                     initial=0))


def wide_keys(shapes: Sequence[Tuple[int, int]]) -> bool:
    """Whether the keys are int64: the row spaces hold 2^31 - 1 rows or
    more together (the int32 key of an invalid descriptor)."""
    return sum(int(r) for r, _ in shapes) >= KEY32_NONE


def descriptor_keys(rows: torch.Tensor, slots: torch.Tensor,
                    col_slot: torch.Tensor, shapes: Sequence[Tuple[int, int]],
                    wide: bool) -> torch.Tensor:
    """Plain version of the key kernel, on any device: (B*S,) keys
    ``first_g + row``, int32 or (``wide``) int64, with the type's max for
    an invalid descriptor (id < 0, id >= R_g, a column no slot spans)."""
    K, G = slots.shape[0], len(shapes)
    cs = col_slot.long()
    g = torch.where((cs >= 0) & (cs < K),
                    slots[:, 0].long()[cs.clamp(0, max(K - 1, 0))], -1)
    gg = g.clamp(0, G - 1)
    nrows = torch.tensor([r for r, _ in shapes], device=rows.device)
    r = rows.long()
    valid = ((g >= 0) & (g < G))[None, :] & (r >= 0) & (r < nrows[gg][None, :])
    firsts = torch.tensor(key_firsts(shapes), device=rows.device)
    none, dtype = ((KEY64_NONE, torch.int64) if wide
                   else (KEY32_NONE, torch.int32))
    key = torch.where(valid, firsts[gg][None, :] + r, none)
    return key.reshape(-1).to(dtype)


def split_keys(keys: torch.Tensor, shapes: Sequence[Tuple[int, int]]):
    """Valid keys -> (row space g, row), int64: the run kernels' decoding
    (a key's g is the last row space whose first key is <= it)."""
    firsts = torch.tensor(key_firsts(shapes), device=keys.device)
    g = torch.searchsorted(firsts, keys.long(), right=True) - 1
    return g, keys.long() - firsts[g]


def _order(rows, slots, col_slot, shapes, wide: bool):
    """(sorted keys (B*S,), order (B*S,) int64): one key per descriptor
    (`descriptor_keys`, int64 when ``wide``, else int32) written by a
    kernel, then a stable ``torch.sort``, so each row's descriptors form
    a run in (b, s) order."""
    global launches_keys
    B, S = rows.shape
    keys = torch.empty((B * S,), dtype=torch.int64 if wide else torch.int32,
                       device=rows.device)
    G = len(shapes)
    nrows = (ctypes.c_int * G)(*[r for r, _ in shapes])
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = build.library().repro_fused_scatter_keys(
            nrows, G, rows.data_ptr(), slots.data_ptr(), col_slot.data_ptr(),
            keys.data_ptr(), B, S, slots.shape[0], int(wide), stream)
    build.check(err, "repro_fused_scatter_keys")
    launches_keys += 1
    return torch.sort(keys, stable=True)


def order_descriptors(rows: torch.Tensor, slots: torch.Tensor,
                      col_slot: torch.Tensor,
                      shapes: Sequence[Tuple[int, int]]):
    """The bookkeeping half: (sorted keys (B*S,), order (B*S,) int64),
    the keys int32 unless `wide_keys` (no dlrm0 cut is), else int64."""
    return _order(rows, slots, col_slot, shapes, wide=wide_keys(shapes))


def _groups(grads, keys):
    G = len(grads)
    wide = keys.dtype == torch.int64
    if not wide and wide_keys([g.shape for g in grads]):
        raise ValueError("int32 keys need row spaces of fewer than 2^31 - 1 "
                         "rows together")
    return (G, (ctypes.c_void_p * G)(*[g.data_ptr() for g in grads]),
            (ctypes.c_int * G)(*[g.shape[1] for g in grads]),
            (ctypes.c_int * G)(*[g.shape[0] for g in grads]), int(wide))


def reduce_short_runs(grads: Sequence[torch.Tensor], gout: torch.Tensor,
                      col_slot: torch.Tensor, keys: torch.Tensor,
                      order: torch.Tensor) -> torch.Tensor:
    """The run kernel: sum every run of ``keys`` shorter than `HOT_RUN`
    descriptors into its row of ``grads``; returns the hot list for
    `reduce_hot_runs` (int64: the item count, a pad, then (start, end,
    first lane) an item, one item a 32-lane slice of a hot run;
    `hot_items` reads it)."""
    global launches
    B, K, dmax = gout.shape
    G, ptrs, dims, nrows, wide = _groups(grads, keys)
    items = (keys.numel() // HOT_RUN + 1) * -(-dmax // 32)
    hot = torch.empty(2 + 3 * items, dtype=torch.int64, device=gout.device)
    hot[:1].zero_()
    with torch.cuda.device(gout.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = build.library().repro_fused_scatter_f32(
            ptrs, dims, nrows, G, keys.data_ptr(), order.data_ptr(),
            keys.numel(), gout.data_ptr(), col_slot.data_ptr(),
            col_slot.numel(), K, dmax, wide, hot.data_ptr(), stream)
    build.check(err, "repro_fused_scatter_f32")
    launches += 1
    return hot


def hot_items(hot: torch.Tensor) -> torch.Tensor:
    """The items of a hot list from `reduce_short_runs`: (n, 3) int64, a
    row (start, end, first lane) a 32-lane slice of a hot run, whose
    descriptors are the sorted positions [start, end)."""
    return hot[2:2 + 3 * int(hot[0])].view(-1, 3)


def reduce_hot_runs(grads: Sequence[torch.Tensor], gout: torch.Tensor,
                    col_slot: torch.Tensor, keys: torch.Tensor,
                    order: torch.Tensor, hot: torch.Tensor) -> None:
    """The hot-run kernel: sum the runs of the hot list ``hot`` (from
    `reduce_short_runs` on the same inputs) into their rows."""
    global launches_hot
    B, K, dmax = gout.shape
    G, ptrs, dims, nrows, wide = _groups(grads, keys)
    with torch.cuda.device(gout.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = build.library().repro_fused_scatter_hot_f32(
            ptrs, dims, nrows, G, keys.data_ptr(), order.data_ptr(),
            gout.data_ptr(), col_slot.data_ptr(), col_slot.numel(), K, dmax,
            wide, hot.data_ptr(), stream)
    build.check(err, "repro_fused_scatter_hot_f32")
    launches_hot += 1


def reduce_runs(grads: Sequence[torch.Tensor], gout: torch.Tensor,
                col_slot: torch.Tensor, keys: torch.Tensor,
                order: torch.Tensor) -> None:
    """The kernel half: sum each run of ``keys`` into its row of ``grads``
    (zero on entry; only touched rows are written): the run kernel, then
    the hot-run kernel on the runs it listed."""
    hot = reduce_short_runs(grads, gout, col_slot, keys, order)
    reduce_hot_runs(grads, gout, col_slot, keys, order, hot)


def fused_scatter(gout: torch.Tensor, rows: torch.Tensor,
                  slots: torch.Tensor, col_slot: torch.Tensor,
                  shapes: Sequence[Tuple[int, int]]) -> List[torch.Tensor]:
    """gout (B, K, dmax) f32 slot gradients on the card, scaled for mean
    slots; rows (B, S) int32 group-local ids (-1 invalid); slots (K, 4)
    int32 (group, col a, col b, mean); col_slot (S,) int32, the slot of
    each descriptor column (-1 none; ``ref.column_slots``, the reference's
    (S,) slot stream); shapes (R_g, D_g) per row space (D_g a multiple of
    4, at most dmax) -> one zero-initialised (R_g, D_g) f32 gradient per
    row space with every valid descriptor's slot gradient added into its
    row.  Launched on the current stream."""
    shapes = _check(gout, rows, slots, col_slot, shapes)
    if not rows.numel() or not slots.shape[0]:
        return [torch.zeros(s, dtype=torch.float32, device=gout.device)
                for s in shapes]
    # ordered first: the sort's scratch is freed before the gradient,
    # as large as the tables, is allocated
    keys, order = order_descriptors(rows, slots, col_slot, shapes)
    grads = [torch.zeros(s, dtype=torch.float32, device=gout.device)
             for s in shapes]
    reduce_runs(grads, gout, col_slot, keys, order)
    return grads
