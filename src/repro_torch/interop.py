"""JAX parameter trees, handed over as numpy, -> torch tensors.

The port keeps the JAX package's param layout so a test can run both
frameworks on the same weights:

    embed            (V, d)
    final_norm       {} for nonparam_ln
    layers/ln1, ln2  {} for nonparam_ln (stacked (L, d) leaves otherwise)
    layers/attn/wq   (L, d, H, hd)     wk, wv (L, d, KH, hd)
    layers/attn/wo   (L, H*hd, d)
    layers/mlp/wg,wu (L, d, f)         wo (L, f, d)

A caller turns a JAX tree into numpy with ``jax.tree.map(np.asarray, p)``;
this module never imports JAX.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch


def params_from_numpy(tree: Any, device="cpu",
                      dtype: Optional[torch.dtype] = None) -> Any:
    """Nested dicts of numpy arrays -> the same nesting of torch tensors on
    ``device``.  ``dtype=None`` keeps each array's dtype;
    a float ``dtype`` casts floating leaves (e.g. ``torch.bfloat16`` rounds
    f32 weights once at load, which gives the values JAX's per-use
    ``quant.cast`` gives).  Empty dicts stay empty dicts."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device, dtype)
                for k, v in tree.items()}
    t = torch.from_numpy(np.array(tree, copy=True)).to(device)
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t

