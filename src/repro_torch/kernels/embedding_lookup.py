"""Single-table embedding lookup on the H100: wrapper of
``csrc/embedding_lookup.cu``.

Replaces the Pallas ``repro/kernels/embedding_lookup.py::
lookup_kernel_call`` (body ``_lookup_kernel``), which the reference
reaches through ``repro.kernels.ops.embedding_lookup`` (the paper's
Figure 9 benchmark, ``benchmarks/fig9_sparsecore.py``): gather and
sum / mean over the valency in one pass, without building the
(B, Vl, D) rows.

Bound on the H100: bytes.  Each valid id reads one row once; there is one
add per 4 bytes.  The fused lookup's bag combine (``csrc/bag_rows.cuh``)
with one slot: a lane group per sample adds its rows in column order with
f32 sums in registers, so the result does not change from run to run.
See the source for the design.

The kernel has no backward, as the reference's: a call that would need a
gradient raises.  `embedding_lookup` launches the kernel on CUDA tensors
and raises on anything it does not take; ``ops`` sends CPU tensors to the
plain version in ``ref``.  ``launches`` counts successful launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.embedding_gather import no_gradient
from repro_torch.kernels.fused_lookup import MAX_DIM

launches = 0           # kernel launches in this process


def embedding_lookup(table: torch.Tensor, ids: torch.Tensor,
                     combiner: str = "sum") -> torch.Tensor:
    """table (V, D) f32 on the card (D a multiple of 4, at most 512; a row
    slice of a row space is fine); ids (B, Vl) int32 (-1 = no value)
    -> (B, D) f32: per sample the sum, or for ``"mean"`` the mean (count
    floored at 1), of its valid rows.  Launched on the current stream."""
    global launches
    if combiner not in ("sum", "mean"):
        raise ValueError(f"unknown combiner {combiner!r}")
    build.check_tensor("table", table, torch.float32, 2)
    build.check_tensor("ids", ids, torch.int32, 2, align=4)
    V, D = table.shape
    if D % 4 or not 0 < D <= MAX_DIM or not V:
        raise ValueError(f"table {tuple(table.shape)}: need rows >= 1 and a "
                         f"dim that is a multiple of 4, <= {MAX_DIM}")
    if V >= 2 ** 31:
        raise ValueError(f"table has {V} rows; int32 ids address at most "
                         f"2^31 - 1")
    if table.device != ids.device:
        raise ValueError("table and ids must be on one device")
    no_gradient("embedding_lookup", [table],
                "ops.GatherRows (lookup(fused=False)) or ops.FusedLookup")
    B, Vl = ids.shape
    out = torch.empty((B, D), dtype=torch.float32, device=ids.device)
    if not B:
        return out
    with torch.cuda.device(ids.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = build.library().repro_embedding_lookup_f32(
            table.data_ptr(), ids.data_ptr(), out.data_ptr(), B, Vl, V, D,
            int(combiner == "mean"), stream)
    build.check(err, "repro_embedding_lookup_f32")
    launches += 1
    return out
