"""Fused multi-table embedding lookup on the H100: wrapper of
``csrc/fused_lookup.cu``.

Replaces the Pallas ``repro/kernels/embedding_lookup.py::
fused_lookup_kernel_call`` (body ``_fused_lookup_kernel``): the DLRM's
default lookup (``embeddings/engine.py::EmbeddingCollection._lookup_fused``)
launches it once a batch over every table.

Bound on the H100: bytes.  Each valid id reads one row of its table once;
there is one add per 4 bytes.  The Pallas kernel takes one (R, Dmax) row
space, every width-group padded and concatenated on each call; this
kernel takes the width-groups where they lie, so no copy of the tables is
made.  One warp per (sample, table) walks the table's descriptor columns
in order with f32 sums in registers, so the result does not change from
run to run.  See the source for the design.

Its gradient is ``ops.FusedLookup``'s, whose backward launches the
fused-scatter kernel (``fused_scatter.py``).
`fused_lookup` launches the kernel on CUDA tensors and raises on anything
it does not take; ``ops`` sends CPU tensors to the plain version in
``ref``.  ``launches`` counts successful launches.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from repro_torch.kernels import build

MAX_GROUPS = 128       # row spaces one launch addresses (csrc MAXG)
MAX_DIM = 512          # widest output row (csrc: 128 lanes * 4 chunks)

launches = 0           # kernel launches in this process


def fused_lookup(groups: Sequence[torch.Tensor], rows: torch.Tensor,
                 slots: torch.Tensor, dmax: int) -> torch.Tensor:
    """groups: G (R_g, D_g) f32 row spaces on the card (D_g a multiple of 4,
    at most ``dmax``); rows (B, S) int32 group-local row ids (-1 invalid);
    slots (K, 4) int32 (group, col a, col b, mean flag) per output slot
    -> (B, K, dmax) f32, lanes >= D_g zero.  Launched on the current
    stream."""
    global launches
    groups = list(groups)
    if not 0 < len(groups) <= MAX_GROUPS:
        raise ValueError(f"need 1..{MAX_GROUPS} row spaces, got {len(groups)}")
    for i, g in enumerate(groups):
        build.check_tensor(f"groups[{i}]", g, torch.float32, 2)
        if g.shape[1] % 4 or g.shape[1] > dmax or not g.shape[0]:
            raise ValueError(f"groups[{i}] {tuple(g.shape)}: need rows >= 1 "
                             f"and a dim that is a multiple of 4, <= {dmax}")
        if g.shape[0] >= 2 ** 31:
            raise ValueError(f"groups[{i}] has {g.shape[0]} rows; int32 row "
                             f"ids address at most 2^31 - 1")
    build.check_tensor("rows", rows, torch.int32, 2, align=4)
    build.check_tensor("slots", slots, torch.int32, 2)
    if slots.shape[1] != 4:
        raise ValueError(f"slots must be (K, 4), got {tuple(slots.shape)}")
    if dmax % 4 or not 0 < dmax <= MAX_DIM:
        raise ValueError(f"dmax {dmax}: need a multiple of 4 in "
                         f"[4, {MAX_DIM}]")
    if len({t.device for t in groups} | {rows.device, slots.device}) != 1:
        raise ValueError("groups, rows and slots must be on one device")
    B, S = rows.shape
    K = slots.shape[0]
    out = torch.empty((B, K, dmax), dtype=torch.float32, device=rows.device)
    if not out.numel():
        return out
    G = len(groups)
    ptrs = (ctypes.c_void_p * G)(*[g.data_ptr() for g in groups])
    dims = (ctypes.c_int * G)(*[g.shape[1] for g in groups])
    nrows = (ctypes.c_int * G)(*[g.shape[0] for g in groups])
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = build.library().repro_fused_lookup_f32(
            ptrs, dims, nrows, G, rows.data_ptr(), slots.data_ptr(),
            out.data_ptr(), B, S, K, dmax, stream)
    build.check(err, "repro_fused_lookup_f32")
    launches += 1
    return out
