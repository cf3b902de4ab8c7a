"""Embedding row gather on the H100: wrapper of ``csrc/embedding_gather.cu``.

Replaces the Pallas ``repro/kernels/embedding_lookup.py::gather_kernel_call``
(body ``_gather_kernel``): the per-table ("legacy") DLRM lookup
(``embeddings/engine.py::_gather_rows``, ``lookup(fused=False)``) launches
it once per table and batch.

Bound on the H100: bytes (a copy: valid rows read once, the output written
once).  One thread moves one 16-byte chunk of an output row, so reads of a
table row and writes of the output are both coalesced.  The kernel has no
backward of its own, as the reference's (``gather_kernel_call`` has no
VJP): its gradient is ``ops.GatherRows``', whose backward launches the
fused-scatter kernel once per row space.  A call of the raw wrapper that
would need a gradient raises, so none goes missing without a word.
`embedding_gather` launches the kernel on CUDA tensors and raises on
anything it does not take; ``ops`` sends CPU tensors to the plain version
in ``ref``.  ``launches`` counts successful launches.
"""
from __future__ import annotations

import torch

from typing import Sequence

from repro_torch.kernels import build

launches = 0           # kernel launches in this process


def no_gradient(name: str, tables: Sequence[torch.Tensor],
                through: str = "ops.GatherRows") -> None:
    """Raise if autograd would need a gradient of ``tables`` from a kernel
    wrapper that has no backward (the port never returns a silent zero
    gradient); ``through`` names the differentiable entry point."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tables):
        raise NotImplementedError(
            f"{name}: the raw kernel wrapper has no backward; take the "
            f"gradient through {through}, or call it under torch.no_grad() "
            f"/ inference_mode()")


def embedding_gather(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """table (V, D) f32 on the card (D a multiple of 4; a row slice of a
    row space is fine); ids (B, Vl) int32 (-1 = no value) -> (B, Vl, D)
    f32, zero rows for ids < 0.  Launched on the current stream."""
    global launches
    build.check_tensor("table", table, torch.float32, 2)
    build.check_tensor("ids", ids, torch.int32, 2, align=4)
    V, D = table.shape
    if D % 4 or not V:
        raise ValueError(f"table {tuple(table.shape)}: need rows >= 1 and a "
                         f"dim that is a multiple of 4")
    if V >= 2 ** 31:
        raise ValueError(f"table has {V} rows; int32 ids address at most "
                         f"2^31 - 1")
    if table.device != ids.device:
        raise ValueError("table and ids must be on one device")
    no_gradient("embedding_gather", [table])
    out = torch.empty((*ids.shape, D), dtype=torch.float32, device=ids.device)
    if not out.numel():
        return out
    with torch.cuda.device(ids.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = build.library().repro_embedding_gather_f32(
            table.data_ptr(), ids.data_ptr(), out.data_ptr(), ids.numel(), V,
            D, stream)
    build.check(err, "repro_embedding_gather_f32")
    launches += 1
    return out
