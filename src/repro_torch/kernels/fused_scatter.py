"""Fused multi-table embedding gradient scatter on the H100: wrapper of
``csrc/fused_scatter.cu``.

Replaces the Pallas ``repro/kernels/embedding_grad.py::
fused_scatter_kernel_call`` (body ``_fused_scatter_kernel``): the backward
of the fused lookup (``ops.FusedLookup``, the port's counterpart of the
reference's ``ops.fused_lookup`` ``custom_vjp``), launched once a train
step over every table.

Bound on the H100: bytes.  The gradient is dense, as in the reference: a
zeroed (R_g, D_g) f32 buffer for every row space, as large as the tables;
the kernel reads each valid descriptor's D_g lanes of the slot gradient
once and writes each touched row once.  Rows repeat (Zipf ids), so the
sum is made deterministic: the descriptors are ordered by (row space,
row) with a stable sort, and one warp sums each run in f32 registers in
the reference's (b, s) order.  Two launches on the same inputs give the
same bits.  See the source for the design.

`fused_scatter` launches on CUDA tensors and raises on anything it does
not take; ``ops`` sends CPU tensors to the plain version in ``ref``.
`order_descriptors` and `reduce_runs` are its two halves, public so that
``chip_smoke.py`` can time each alone.  ``launches`` counts launches of
the run kernel, which `reduce_runs` makes (one a `fused_scatter` call).
"""
from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.fused_lookup import MAX_DIM, MAX_GROUPS

launches = 0           # launches of the run kernel (`reduce_runs`)


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


def order_descriptors(rows: torch.Tensor, slots: torch.Tensor,
                      col_slot: torch.Tensor,
                      shapes: Sequence[Tuple[int, int]]):
    """The bookkeeping half: (sorted keys (B*S,) int64, order (B*S,)
    int64).  One key per descriptor, (group << 32) | row or int64 max for
    an invalid one, written by a kernel; then a stable ``torch.sort``, so
    each row's descriptors form a run in (b, s) order."""
    B, S = rows.shape
    keys = torch.empty((B * S,), dtype=torch.int64, device=rows.device)
    G = len(shapes)
    nrows = (ctypes.c_int * G)(*[r for r, _ in shapes])
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = build.library().repro_fused_scatter_keys(
            nrows, G, rows.data_ptr(), slots.data_ptr(), col_slot.data_ptr(),
            keys.data_ptr(), B, S, slots.shape[0], stream)
    build.check(err, "repro_fused_scatter_keys")
    return torch.sort(keys, stable=True)


def reduce_runs(grads: Sequence[torch.Tensor], gout: torch.Tensor,
                col_slot: torch.Tensor, keys: torch.Tensor,
                order: torch.Tensor) -> None:
    """The kernel half: sum each run of ``keys`` into its row of ``grads``
    (zero on entry; only touched rows are written)."""
    global launches
    B, K, dmax = gout.shape
    G = len(grads)
    ptrs = (ctypes.c_void_p * G)(*[g.data_ptr() for g in grads])
    dims = (ctypes.c_int * G)(*[g.shape[1] for g in grads])
    nrows = (ctypes.c_int * G)(*[g.shape[0] for g in grads])
    with torch.cuda.device(gout.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = build.library().repro_fused_scatter_f32(
            ptrs, dims, nrows, G, keys.data_ptr(), order.data_ptr(),
            keys.numel(), gout.data_ptr(), col_slot.data_ptr(),
            col_slot.numel(), K, dmax, stream)
    build.check(err, "repro_fused_scatter_f32")
    launches += 1


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
