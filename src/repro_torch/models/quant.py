"""Mixed-precision choke point of the port (``repro/models/quant.py``
``cast`` and ``take``).

The JAX package keeps f32 params and casts each weight to bf16 where it is
used; these two functions are that cast.  The int8 ``QTensor`` storage path
is not ported yet (ROADMAP.md, queue 1, item 4).
"""
from __future__ import annotations

import torch


def cast(w: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """Weight -> compute dtype (no copy when it already is)."""
    return w.to(dtype)


def take(w: torch.Tensor, ids: torch.Tensor,
         dtype=torch.bfloat16) -> torch.Tensor:
    """Row gather for embedding tables, then cast."""
    return w[ids].to(dtype)
