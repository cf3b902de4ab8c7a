"""Device dispatch for the port's kernels.

The choice follows the device of the tensors given: a CPU tensor goes to
the plain PyTorch version (``ref``); a CUDA tensor goes to the hand-written
kernel, and if its build, load or launch fails the call raises.  There is
no fallback from the card to the plain version.
"""
from __future__ import annotations

from typing import Optional, Sequence

from repro_torch.kernels import decode_attention as DA
from repro_torch.kernels import embedding_gather as EG
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import fused_lookup as FL
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


def embedding_gather(table, ids):
    """table (V, D); ids (B, Vl) -> (B, Vl, D), zero rows for ids < 0."""
    if _device_type(table, ids) == "cuda":
        return EG.embedding_gather(table, ids)
    return REF.embedding_gather_ref(table, ids)
