"""Device dispatch for the serving-path kernels.

The choice follows the device of the tensors given: a CPU tensor goes to
the plain PyTorch version (``ref``); a CUDA tensor goes to the hand-written
kernel, and if its build, load or launch fails the call raises.  There is
no fallback from the card to the plain version.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.kernels import decode_attention as DA
from repro_torch.kernels import flash_attention as FA
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
