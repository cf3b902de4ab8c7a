"""Device dispatch for the port's kernels.

The choice follows the device of the tensors given: a CPU tensor goes to
the plain PyTorch version (``ref``); a CUDA tensor goes to the hand-written
kernel, and if its build, load or launch fails the call raises.  There is
no fallback from the card to the plain version.

`FusedLookup` is the port's counterpart of the reference's
``ops.fused_lookup`` ``custom_vjp``: the fused lookup forward, the fused
scatter backward, each dispatched the same way.  `GatherRows` makes the
per-table route differentiable: the row gather forward, the fused scatter
backward, once per row space.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import decode_attention as DA
from repro_torch.kernels import embedding_gather as EG
from repro_torch.kernels import embedding_lookup as EL
from repro_torch.kernels import embedding_scatter as ES
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import fused_lookup as FL
from repro_torch.kernels import fused_scatter as FS
from repro_torch.kernels import ref as REF


def _device_type(*ts) -> str:
    kinds = {t.device.type for t in ts}
    if len(kinds) != 1:
        raise ValueError(f"tensors on mixed devices: {sorted(kinds)}")
    kind = kinds.pop()
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"no kernel or plain version for device {kind!r}")
    return kind


def paged_decode_attention(q, k, v, seq_lens, *,
                           window: Optional[int] = None,
                           softcap: Optional[float] = None,
                           scale: Optional[float] = None):
    """q (B, H, d); k, v (B, S, KH, d); seq_lens (B,) -> (B, H, d)."""
    if _device_type(q, k, v, seq_lens) == "cuda":
        return DA.paged_decode_attention(q, k, v, seq_lens, window=window,
                                         softcap=softcap, scale=scale)
    return REF.paged_decode_attention_ref(q, k, v, seq_lens, window=window,
                                          softcap=softcap, scale=scale)


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    scale: Optional[float] = None):
    """q (B, H, T, d); k, v (B, KH, S, d) -> (B, H, T, d)."""
    if _device_type(q, k, v) == "cuda":
        return FA.flash_attention(q, k, v, causal=causal, window=window,
                                  softcap=softcap, scale=scale)
    return REF.flash_attention_ref(q, k, v, causal=causal, window=window,
                                   softcap=softcap, scale=scale)


def fused_lookup(groups: Sequence, rows, slots, dmax: int):
    """groups: (R_g, D_g) row spaces; rows (B, S) group-local ids;
    slots (K, 4) (group, col a, col b, mean) -> (B, K, dmax)."""
    if _device_type(*groups, rows, slots) == "cuda":
        return FL.fused_lookup(groups, rows, slots, dmax)
    return REF.fused_lookup_ref(groups, rows, slots, dmax)


def fused_lookup_q(qgroups: Sequence, scales: Sequence, rows, slots,
                   dmax: int):
    """qgroups: (R_g, D_g) int8 row spaces; scales: (R_g, ceil(D_g / 128))
    f32 each; rows, slots as `fused_lookup` -> (B, K, dmax) f32, each
    row dequantised before it is added (the int8 serving lookup)."""
    if _device_type(*qgroups, *scales, rows, slots) == "cuda":
        return FL.fused_lookup_q(qgroups, scales, rows, slots, dmax)
    return REF.fused_lookup_q_ref(qgroups, scales, rows, slots, dmax)


def embedding_gather(table, ids):
    """table (V, D); ids (B, Vl) -> (B, Vl, D), zero rows for ids < 0."""
    if _device_type(table, ids) == "cuda":
        return EG.embedding_gather(table, ids)
    return REF.embedding_gather_ref(table, ids)


def embedding_lookup(table, ids, combiner: str = "sum"):
    """table (V, D); ids (B, Vl), -1 = no value -> (B, D): each sample's
    valid rows summed, or averaged for ``"mean"`` (count floored at 1)."""
    if _device_type(table, ids) == "cuda":
        return EL.embedding_lookup(table, ids, combiner)
    return REF.embedding_lookup_ref(table, ids, combiner)


def embedding_scatter(grads, ids, vocab: int):
    """grads (N, D); ids (N,) with equal ids adjacent (``embeddings/
    dedup.dedup_ids``' output, or any sorted stream), -1 = none
    -> (vocab, D): zeros, each valid id's rows summed into its row."""
    if _device_type(grads, ids) == "cuda":
        return ES.embedding_scatter(grads, ids, vocab)
    return REF.embedding_scatter_ref(grads, ids, vocab)


def fused_scatter(gout, rows, slots, col_slot,
                  shapes: Sequence[Tuple[int, int]]) -> List[torch.Tensor]:
    """gout (B, K, dmax) slot gradients (scaled for mean slots); rows
    (B, S) group-local ids; slots (K, 4); col_slot (S,) slot of each
    column -> one (R_g, D_g) gradient per row space of ``shapes``."""
    if _device_type(gout, rows, slots, col_slot) == "cuda":
        return FS.fused_scatter(gout, rows, slots, col_slot, shapes)
    return REF.fused_scatter_ref(gout, rows, slots, shapes, col_slot)


def _mean_scaled(g, rows, slots):
    """``g`` (B, K, dmax) with each mean slot's rows divided by its count
    of valid ids, floored at 1 (the reference's ``_fused_lookup_bwd``:
    f32, times the reciprocal).  Counts come from a prefix sum over the
    descriptor columns, so no host sync is needed."""
    S = rows.shape[1]
    csum = F.pad((rows >= 0).to(torch.int32).cumsum(dim=1), (1, 0))
    a = slots[:, 1].long().clamp(0, S)
    b = torch.maximum(slots[:, 2].long().clamp(0, S), a)
    cnt = (csum[:, b] - csum[:, a]).float()                 # (B, K)
    scale = torch.where(slots[:, 3][None, :] != 0,
                        1.0 / cnt.clamp_min(1.0), 1.0)
    return (g.float() * scale[..., None]).contiguous()


class FusedLookup(torch.autograd.Function):
    """Differentiable one-launch multi-table lookup:
    ``FusedLookup.apply(rows, slots, col_slot, dmax, *groups)`` ->
    (B, K, dmax); ``col_slot`` (S,) int32 is `ref.column_slots` of
    ``slots``, which the caller caches with its layout.

    Forward: `fused_lookup`.  Backward: the mean scaling of
    `_mean_scaled`, then `fused_scatter`; gradients flow to the row spaces
    only (None for ``rows``, ``slots``, ``col_slot`` and ``dmax``).  Both
    halves dispatch by device: the kernels on the card, the plain versions
    on the CPU."""

    @staticmethod
    def forward(ctx, rows, slots, col_slot, dmax, *groups):
        ctx.save_for_backward(rows, slots, col_slot)
        ctx.shapes = [tuple(g.shape) for g in groups]
        return fused_lookup(groups, rows, slots, dmax)

    @staticmethod
    def backward(ctx, g):
        rows, slots, col_slot = ctx.saved_tensors
        if not any(ctx.needs_input_grad[4:]):
            return (None,) * (4 + len(ctx.shapes))
        grads = fused_scatter(_mean_scaled(g, rows, slots), rows, slots,
                              col_slot, ctx.shapes)
        return (None, None, None, None, *grads)


class GatherRows(torch.autograd.Function):
    """Differentiable per-table row gathers from ONE row space:
    ``GatherRows.apply(space, spans, *ids)`` -> one (B, Vl_t, D) tensor
    per table t, where ``spans[t] = (offset, V_t)`` places the table's
    rows in ``space`` (R, D) and ``ids[t]`` (B, Vl_t) int32 are its
    table-local ids (-1 = no value; an id >= V_t reads the table's last
    row).

    Forward: one `embedding_gather` per table on its row slice (the gather
    kernel on the card, its plain version on the CPU).  Backward: ONE
    `fused_scatter` over the row space with one slot per descriptor
    column: ``gout`` (B, S, D) the tables' output gradients side by side,
    slots (S, 4) = (0, j, j + 1, 0), ``col_slot`` = arange(S), and the
    ids offset into the row space.  So autograd allocates one
    row-space-sized gradient however many tables share it, no new kernel
    is needed, and the card sums each row in (b, s) order, the same bits
    on every run.  Gradients flow to ``space`` only."""

    @staticmethod
    def forward(ctx, space, spans, *ids):
        ctx.spans = tuple(spans)
        ctx.shape = tuple(space.shape)
        ctx.save_for_backward(*ids)
        return tuple(embedding_gather(space[o:o + v], i)
                     for (o, v), i in zip(ctx.spans, ids))

    @staticmethod
    def backward(ctx, *gouts):
        ids = ctx.saved_tensors
        if not ctx.needs_input_grad[0]:
            return (None, None, *[None] * len(ids))
        rows = torch.cat([torch.where(i >= 0, i.clamp_max(v - 1) + o, -1)
                          for (o, v), i in zip(ctx.spans, ids)],
                         dim=1).to(torch.int32)
        gout = torch.cat(gouts, dim=1).float().contiguous()    # (B, S, D)
        j = torch.arange(rows.shape[1], dtype=torch.int32,
                         device=rows.device)
        zero = torch.zeros_like(j)
        slots = torch.stack([zero, j, j + 1, zero], dim=1)
        grad, = fused_scatter(gout, rows, slots, j, [ctx.shape])
        return (grad, None, *[None] * len(ids))
