"""Gradient compression for the data-parallel exchange (port of
``repro/parallel/compression.py``).

Two layers, as the reference's:

  * ``compressed_allreduce`` — the real exchange: each rank holds its own
    gradient tree and gets back the mean over the context's batch axes,
    through the context's transport (``parallel/context.py``):

      - ``int8``: the ranks agree on one shared scale a leaf (the maxima
        of every wired leaf in one vector, one MAX all-reduce), each
        quantises locally, the int8 payloads are all-gathered (1 byte an
        element on the wire) and summed in int32, which is exact, then
        dequantised once;
      - ``topk``: each rank keeps exactly ``k = frac * n`` entries of
        largest |g| and sends them as (value, int32 index) pairs (an
        all-gather of each); every rank adds the ranks' pairs into a zero
        f32 tensor in rank order.  The reference emulates this exchange
        with a dense ``psum`` of the exact-k tensors: the same sum, in
        another order.

  * ``compress_grads`` — the one-device round trip (quantise, dequantise
    in place of the exchange), so the knob has the same numerics where
    there is nothing to exchange over.

Small tensors (``size < MIN_WIRE_SIZE``) and scalars pass through at full
width in both layers, summed in f32 as the ``none`` scheme's are.

Bits.  The reference's ``max(|g|, 1e-12) / 127`` runs jitted, and XLA
compiles a division by a constant to a product with its f32 reciprocal:
the port computes that product, so int8 quantises with the reference's
scale, bit for bit.  ``torch.round`` rounds half to even, as ``jnp.round``
does.  topk keeps by index through a stable descending sort of |g|, so
ties go to the lower index as ``jax.lax.top_k`` breaks them: the kept set
is the reference's, also on a constant tensor.

``wire_bytes`` is the shared accounting, static from shapes: the payload
bytes a rank contributes to one exchange, the scale overhead apart, the
convention compression papers quote ratios in.  The bytes the transport
really moves are the context's counter (``context.wire_bytes``).
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from repro_torch.optim import adam as OPT

# below this many elements a tensor is exchanged at full width
MIN_WIRE_SIZE = 64
TOPK_FRAC = 0.1
SCHEMES = ("none", "int8", "topk")

# 1 / 127 in f32: the reference's jitted `/ 127.0`
_INV_127 = float(np.float32(1.0) / np.float32(127.0))


def _wired(g: torch.Tensor) -> bool:
    return g.dim() > 0 and g.numel() >= MIN_WIRE_SIZE


def _int8_scale(gmax: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(gmax, 1e-12) * _INV_127


def _quantise(gf: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)


def _int8_roundtrip(g: torch.Tensor) -> torch.Tensor:
    if not _wired(g):
        return g
    gf = g.float()
    scale = _int8_scale(gf.abs().amax())
    return (_quantise(gf, scale).float() * scale).to(g.dtype)


def _topk_count(n: int, frac: float) -> int:
    return max(1, int(n * frac))


def _topk_index(flat: torch.Tensor, frac: float) -> torch.Tensor:
    """Indices of the exact-k largest |flat|, ties to the lower index (a
    threshold mask would keep every element tied at the threshold)."""
    k = _topk_count(flat.numel(), frac)
    return torch.sort(flat.abs(), descending=True, stable=True).indices[:k]


def _topk_roundtrip(g: torch.Tensor, frac: float = TOPK_FRAC
                    ) -> torch.Tensor:
    if not _wired(g):
        return g
    flat = g.reshape(-1)
    idx = _topk_index(flat, frac)
    out = torch.zeros_like(flat)
    out[idx] = flat[idx]
    return out.reshape(g.shape)


def compress_grads(grads, scheme: str):
    """Quantise-dequantise round trip of every leaf (no exchange); dtype
    kept.  ``grads``: a tree of dicts, lists and tuples of tensors."""
    if scheme == "int8":
        return OPT.tree_map(_int8_roundtrip, grads)
    if scheme == "topk":
        return OPT.tree_map(_topk_roundtrip, grads)
    raise ValueError(scheme)


# ---------------------------------------------------------------------------
# The exchange (every rank of the batch axes calls it, in the same order)
# ---------------------------------------------------------------------------

def _refill(tree, it):
    """``tree`` with its leaves replaced, in ``OPT.leaves`` order (dict
    keys sorted), by the items of ``it``."""
    if isinstance(tree, dict):
        return {k: _refill(tree[k], it) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_refill(v, it) for v in tree)
    return next(it)


def _int8_sum(q: torch.Tensor, axis: str, ctx) -> torch.Tensor:
    """Exact int32 sum of every rank's int8 payload: all-gathered as int8,
    added in int32."""
    parts = ctx.all_gather(q.reshape(1, -1), axis)
    total = parts[0].to(torch.int32)
    for r in range(1, parts.shape[0]):
        total += parts[r]
    return total.reshape(q.shape)


def _topk_sum_into(x: torch.Tensor, g: torch.Tensor, axis: str, ctx,
                   frac: float) -> None:
    """``x`` (f32, ``g``'s shape) := the sum of every rank's exact-k
    tensor of ``g``: the (value, int32 index) pairs all-gathered and
    added in rank order."""
    flat = g.reshape(-1)
    idx = _topk_index(flat, frac)
    vals = ctx.all_gather(flat[idx].reshape(1, -1), axis)
    rows = ctx.all_gather(idx.to(torch.int32).reshape(1, -1), axis)
    out = x.zero_().reshape(-1)
    for r in range(vals.shape[0]):
        out.index_add_(0, rows[r].long(), vals[r].float())


def compressed_allreduce(grads, scheme: str, axes: Sequence[str], ctx, *,
                         frac: float = TOPK_FRAC):
    """Mean of a gradient tree over the ranks of ``axes`` (``ctx``'s batch
    axes: none, or its data axis), with compressed payloads.  Each rank
    passes its own gradients and gets the mean back, in each leaf's
    dtype; an f32 leaf is overwritten with its mean and returned.  Every
    rank of the axis must call it on trees of the same shapes."""
    if scheme not in SCHEMES:
        raise ValueError(scheme)
    if not axes:
        return grads if scheme == "none" else compress_grads(grads, scheme)
    (axis,) = axes
    n = ctx.axis_size(axis)
    flat = OPT.leaves(grads)
    wired = [scheme != "none" and _wired(g) for g in flat]
    scales = None
    if scheme == "int8" and any(wired):
        # one shared scale a wired leaf, agreed in one collective
        gmax = torch.stack([g.detach().float().abs().amax()
                            for g, w in zip(flat, wired) if w])
        scales = iter(_int8_scale(ctx.all_reduce(gmax, axis, op="max"))
                      .unbind(0))
    out = []
    for g, w in zip(flat, wired):
        x = g if g.dtype == torch.float32 else g.float()
        if not w:
            ctx.all_reduce_(x, axis)
        elif scheme == "int8":
            scale = next(scales)
            x.copy_(_int8_sum(_quantise(x, scale), axis, ctx)).mul_(scale)
        else:
            _topk_sum_into(x, g, axis, ctx, frac)
        out.append(x.div_(n).to(g.dtype))
    return _refill(grads, iter(out))


# ---------------------------------------------------------------------------
# Wire accounting
# ---------------------------------------------------------------------------

def wire_bytes(tree, scheme: str, *, frac: float = TOPK_FRAC
               ) -> Dict[str, int]:
    """A rank's payload bytes for ONE gradient exchange (static, from
    shapes).  ``wire_bytes`` is the tensor payload; the shared scales are
    metered apart as ``wire_overhead_bytes`` (4 bytes a compressed
    tensor); ``wire_bytes_full`` is the uncompressed payload."""
    if scheme not in SCHEMES:
        raise ValueError(scheme)
    payload = overhead = full = 0
    for leaf in OPT.leaves(tree):
        n, b = leaf.numel(), leaf.element_size()
        full += n * b
        if leaf.dim() == 0 or n < MIN_WIRE_SIZE or scheme == "none":
            payload += n * b
        elif scheme == "int8":
            payload += n            # 1 byte an element
            overhead += 4           # the shared f32 scale
        else:                       # topk: (value, int32 index) pairs
            payload += _topk_count(n, frac) * (b + 4)
    return {"wire_bytes": payload, "wire_overhead_bytes": overhead,
            "wire_bytes_full": full}
