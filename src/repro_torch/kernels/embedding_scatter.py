"""Embedding gradient scatter over deduplicated ids on the H100: wrapper of
``csrc/embedding_scatter.cu``.

Replaces the Pallas ``repro/kernels/embedding_grad.py::
scatter_kernel_call`` (body ``_scatter_kernel``), the SparseCore Flush
unit, which the reference reaches through
``repro.kernels.ops.embedding_scatter`` with the output of
``embeddings/dedup.py::dedup_ids`` (paper §3.4: ids are deduplicated
before the backward).

Contract: the ids may be any stream in which equal ids are ADJACENT —
``dedup_ids``' unique sorted ids with a -1 tail, or any sorted stream.
A -1 anywhere adds nothing and an id >= V is dropped.  A run of equal ids
is summed in index order by the warp that owns its head (one lane group
of it, several runs at once a warp, when the run ends within the warp's
32 positions), then its row is written once: for unique ids the result is
bitwise the reference's (0 + each row); for adjacent duplicates it is
bitwise ``index_add_`` in index order (``ref.embedding_scatter_ref`` on
the CPU, or on the card under ``torch.use_deterministic_algorithms``).
Non-adjacent duplicates are NOT supported: each run writes its row, and
the last one written wins.

Bound on the H100: bytes, most of them the zero fill of the (V, D) table,
which is part of the operation, as in the reference.  `embedding_scatter`
is the fill then `scatter_rows`, the kernel half, public so that
``chip_smoke.py`` can time each alone.  Both launch on CUDA tensors and
raise on anything they do not take; ``ops`` sends CPU tensors to the
plain version in ``ref``.  ``launches`` counts launches of the kernel.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.fused_lookup import MAX_DIM

launches = 0           # kernel launches in this process


def _check(grads: torch.Tensor, ids: torch.Tensor, vocab: int) -> None:
    build.check_tensor("grads", grads, torch.float32, 2)
    build.check_tensor("ids", ids, torch.int32, 1, align=4)
    N, D = grads.shape
    if ids.shape[0] != N:
        raise ValueError(f"ids {tuple(ids.shape)} and grads "
                         f"{tuple(grads.shape)} disagree on N")
    if D % 4 or not 0 < D <= MAX_DIM:
        raise ValueError(f"grads {tuple(grads.shape)}: need a dim that is a "
                         f"multiple of 4, <= {MAX_DIM}")
    if not 0 < vocab < 2 ** 31:
        raise ValueError(f"vocab {vocab}: need 1 <= vocab < 2^31")
    if grads.device != ids.device:
        raise ValueError("grads and ids must be on one device")


def scatter_rows(out: torch.Tensor, grads: torch.Tensor,
                 ids: torch.Tensor) -> None:
    """The kernel half: write each run's summed rows into ``out`` (V, D)
    f32, zero on entry (only the named rows are written)."""
    global launches
    V = out.shape[0]
    _check(grads, ids, V)
    build.check_tensor("out", out, torch.float32, 2)
    if out.shape[1] != grads.shape[1] or out.device != grads.device:
        raise ValueError(f"out {tuple(out.shape)} on {out.device} does not "
                         f"match grads {tuple(grads.shape)} on "
                         f"{grads.device}")
    if not ids.numel():
        return
    with torch.cuda.device(ids.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = build.library().repro_embedding_scatter_f32(
            grads.data_ptr(), ids.data_ptr(), out.data_ptr(), ids.numel(), V,
            grads.shape[1], stream)
    build.check(err, "repro_embedding_scatter_f32")
    launches += 1


def embedding_scatter(grads: torch.Tensor, ids: torch.Tensor,
                      vocab: int) -> torch.Tensor:
    """grads (N, D) f32 on the card (D a multiple of 4, at most 512); ids
    (N,) int32 with equal ids adjacent (-1 = no value) -> (vocab, D) f32:
    zeros, each valid id's run of rows summed into its row.  Launched on
    the current stream."""
    _check(grads, ids, vocab)
    out = torch.zeros((vocab, grads.shape[1]), dtype=torch.float32,
                      device=grads.device)
    scatter_rows(out, grads, ids)
    return out
