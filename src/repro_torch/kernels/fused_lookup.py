"""Fused multi-table embedding lookup on the H100: wrapper of
``csrc/fused_lookup.cu``.

Replaces the Pallas ``repro/kernels/embedding_lookup.py::
fused_lookup_kernel_call`` (body ``_fused_lookup_kernel``): the DLRM's
default lookup (``embeddings/engine.py::EmbeddingCollection._lookup_fused``)
launches it once a batch over every table.  `fused_lookup_q` is the same
kernel body over int8 row spaces with per-tile scales (the ``scales=``
branch, body ``_fused_lookup_kernel_q``; the reference's
``ops.fused_lookup_q``, the int8-table serving lookup): each gathered
row is dequantised in registers before it is added, so the row stream is
one byte a lane.

Bound on the H100: bytes.  Each valid id reads one row of its table once;
there is one add per 4 bytes.  The Pallas kernel takes one (R, Dmax) row
space, every width-group padded and concatenated on each call; this
kernel takes the width-groups where they lie, so no copy of the tables is
made.  The blocks run table by table (``csrc/bag_rows.cuh``, shared with
the single-table lookup): lane groups sized by each table's dim take one
bag (sample) each and add its valid rows in column order with f32 sums
in registers, so the result does not change from run to run.  See the
source for the design.

Its gradient is ``ops.FusedLookup``'s, whose backward launches the
fused-scatter kernel (``fused_scatter.py``).
`fused_lookup` and `fused_lookup_q` launch the kernel on CUDA tensors and
raise on anything they do not take; ``ops`` sends CPU tensors to the
plain versions in ``ref``.  ``launches`` and ``launches_q`` count their
successful launches.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from repro_torch.kernels import build

MAX_GROUPS = 128       # row spaces one launch addresses (csrc MAXG)
MAX_DIM = 512          # widest output row (csrc: 128 lanes * 4 chunks)

TILE = 128             # lanes a scale covers (csrc: 32 chunks of 4)

launches = 0           # launches of the f32 kernel in this process
launches_q = 0         # launches of the int8 kernel in this process


def _check(groups, rows, slots, dmax, dtype, align):
    """Raise unless the kernel takes these inputs; returns (B, S, K)."""
    if not 0 < len(groups) <= MAX_GROUPS:
        raise ValueError(f"need 1..{MAX_GROUPS} row spaces, got {len(groups)}")
    for i, g in enumerate(groups):
        build.check_tensor(f"groups[{i}]", g, dtype, 2, align=align)
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
    return (*rows.shape, slots.shape[0])


def fused_lookup(groups: Sequence[torch.Tensor], rows: torch.Tensor,
                 slots: torch.Tensor, dmax: int) -> torch.Tensor:
    """groups: G (R_g, D_g) f32 row spaces on the card (D_g a multiple of 4,
    at most ``dmax``); rows (B, S) int32 group-local row ids (-1 invalid);
    slots (K, 4) int32 (group, col a, col b, mean flag) per output slot
    -> (B, K, dmax) f32, lanes >= D_g zero.  Launched on the current
    stream."""
    global launches
    groups = list(groups)
    B, S, K = _check(groups, rows, slots, dmax, torch.float32, 16)
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


def fused_lookup_q(qgroups: Sequence[torch.Tensor],
                   scales: Sequence[torch.Tensor], rows: torch.Tensor,
                   slots: torch.Tensor, dmax: int) -> torch.Tensor:
    """qgroups: G (R_g, D_g) int8 row spaces on the card (D_g a multiple of
    4, at most ``dmax``), scales: G (R_g, ceil(D_g / 128)) f32, one per
    128-lane tile from lane 0 (``models/quant.quantize_row_space``); rows,
    slots as `fused_lookup` -> (B, K, dmax) f32: per slot the sum (or the
    mean) of its valid rows, each dequantised (q * its tile's scale, f32)
    before it is added; lanes >= D_g zero.  Launched on the current
    stream."""
    global launches_q
    qgroups, scales = list(qgroups), list(scales)
    B, S, K = _check(qgroups, rows, slots, dmax, torch.int8, 4)
    if len(scales) != len(qgroups):
        raise ValueError(f"{len(scales)} scale tables for {len(qgroups)} "
                         f"row spaces")
    for i, (q, sc) in enumerate(zip(qgroups, scales)):
        build.check_tensor(f"scales[{i}]", sc, torch.float32, 2, align=4)
        want = (q.shape[0], -(-q.shape[1] // TILE))
        if tuple(sc.shape) != want:
            raise ValueError(f"scales[{i}] must be {want} (one per "
                             f"{TILE}-lane tile), got {tuple(sc.shape)}")
        if sc.device != q.device:
            raise ValueError("scales must be on the row spaces' device")
    out = torch.empty((B, K, dmax), dtype=torch.float32, device=rows.device)
    if not out.numel():
        return out
    G = len(qgroups)
    ptrs = (ctypes.c_void_p * G)(*[g.data_ptr() for g in qgroups])
    sptrs = (ctypes.c_void_p * G)(*[s.data_ptr() for s in scales])
    dims = (ctypes.c_int * G)(*[g.shape[1] for g in qgroups])
    nrows = (ctypes.c_int * G)(*[g.shape[0] for g in qgroups])
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = build.library().repro_fused_lookup_q8(
            ptrs, sptrs, dims, nrows, G, rows.data_ptr(), slots.data_ptr(),
            out.data_ptr(), B, S, K, dmax, stream)
    build.check(err, "repro_fused_lookup_q8")
    launches_q += 1
    return out
