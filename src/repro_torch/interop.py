"""JAX parameter trees, handed over as numpy, -> torch tensors.

The port keeps the JAX package's param layout so a test can run both
frameworks on the same weights:

    embed            (V, d)
    final_norm       {} for nonparam_ln
    layers/ln1, ln2  {} for nonparam_ln (stacked (L, d) leaves otherwise)
    layers/attn/wq   (L, d, H, hd)     wk, wv (L, d, KH, hd)
    layers/attn/wo   (L, H*hd, d)      (H*hd != d: mistral-nemo, gemma2)
    layers/attn/bq   (L, H, hd)        bk, bv (L, KH, hd) (qkv_bias: qwen2)
    layers/mlp/wg,wu (L, d, f)         wo (L, f, d)
    layers/post_ln1, post_ln2          as ln1 (post_norm: gemma2)
    head             (d, V)            absent with tied embeddings (olmo,
                                       gemma2's 256000-row ``embed``)
    vision_proj      (vision_dim, d)   a VLM's patch projection (internvl2)

a MoE model's (``models/moe.py``), over its Ls = L - dense_layers stacked
layers, in place of ``mlp``:

    layers/moe/router    (Ls, d, E)
    layers/moe/wg,wu     (Ls, E, d, F)   wo (Ls, E, F, d)
    layers/moe/shared    {wg, wu (Ls, d, f), wo (Ls, f, d)} (kimi-k2)
    dense_prefix         list of unstacked blocks {ln1, attn, ln2, mlp}

whisper's (``models/whisper.py``; layernorm ``{w, b}`` norms, the
embedding tied):

    embed (V, d)     enc_final_norm, final_norm {w, b}
    encoder/ln1, attn, ln2, mlp        stacked over encoder_layers, as
                                       ``layers`` (``mlp/wi``, ``wo``)
    decoder/ln1, attn, ln_x, ln2, mlp  stacked over num_layers
    decoder/xattn/wq, wk, wv, wo       the cross-attention, no qkv bias

and the DLRM's (``models/dlrm.py``):

    tables/local_d{D}  (R, D) f32     one row space per embedding width
    bottom, top        lists of {"w": (in, out), "b": (out,)}

Over ranks (``parallel/context.py``), `rank_params` cuts a numpy tree of
the JAX package's global row spaces to one rank's shards (shard m of each
``tables/group_d{D}``, everything else whole), `shard_params` cuts a
torch tree the same way, and `gather_params` puts a rank's tree back
together (for a comparison on one rank, or a checkpoint).

A caller turns a JAX tree into numpy with ``jax.tree.map(np.asarray, p)``;
this module never imports JAX.  A tree that the JAX package's
``quant.quantize_params`` made keeps its int8 leaves through that map (each
a ``QTensor`` of numpy ``q`` and ``scale``): any leaf with ``q``, ``scale``
and ``tile`` becomes the port's `quant.QTensor`, int8 values and f32 scales
as they are.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from repro_torch.embeddings.engine import row_sharded
from repro_torch.models.quant import QTensor
from repro_torch.parallel.context import ParallelContext


def params_from_numpy(tree: Any, device="cpu",
                      dtype: Optional[torch.dtype] = None) -> Any:
    """Nested dicts, lists and tuples of numpy arrays -> the same nesting
    of torch tensors on ``device``.  ``dtype=None`` keeps each array's dtype;
    a float ``dtype`` casts floating leaves (e.g. ``torch.bfloat16`` rounds
    f32 weights once at load, which gives the values JAX's per-use
    ``quant.cast`` gives; a ``QTensor``'s values and scales keep their
    dtypes).  Empty dicts stay empty dicts."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device, dtype)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_numpy(v, device, dtype) for v in tree)
    if all(hasattr(tree, a) for a in ("q", "scale", "tile")):
        return QTensor(params_from_numpy(tree.q, device),
                       params_from_numpy(tree.scale, device), int(tree.tile))
    t = torch.from_numpy(np.array(tree, copy=True)).to(device)
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t



def _sharded(path, ctx: ParallelContext) -> bool:
    return (ctx.has_mesh and ctx.model_axis_size > 1 and len(path) >= 2
            and path[-2] == "tables" and row_sharded(path[-1]))


def _map_shards(tree, ctx: ParallelContext, fn, path=()):
    """``fn(leaf, sharded)`` over every leaf of a DLRM tree."""
    if isinstance(tree, dict):
        return {k: _map_shards(v, ctx, fn, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_shards(v, ctx, fn, path) for v in tree)
    return fn(tree, _sharded(path, ctx))


def rank_params(tree: Any, ctx: ParallelContext, device="cpu") -> Any:
    """A numpy DLRM tree of global row spaces -> this rank's torch tree:
    rows [m * rps, (m + 1) * rps) of each ``tables/group_d{D}`` (m the
    rank's model coordinate), every other leaf whole."""
    ms, m = ctx.model_axis_size, ctx.axis_index(ctx.model_axis)

    def cut(x, sharded):
        x = np.asarray(x)
        if sharded:
            rps = x.shape[0] // ms
            x = x[m * rps:(m + 1) * rps]
        return params_from_numpy(x, device)
    return _map_shards(tree, ctx, cut)


def shard_params(tree: Any, ctx: ParallelContext) -> Any:
    """A whole torch DLRM tree (the same on every rank) -> this rank's:
    rows [m * rps, (m + 1) * rps) of each ``tables/group_d{D}`` copied,
    every other leaf as it is."""
    ms, m = ctx.model_axis_size, ctx.axis_index(ctx.model_axis)

    def cut(x, sharded):
        if not sharded:
            return x
        rps = x.shape[0] // ms
        return x[m * rps:(m + 1) * rps].clone()
    return _map_shards(tree, ctx, cut)


def gather_params(tree: Any, ctx: ParallelContext) -> Any:
    """A rank's torch tree -> the whole tree, on every rank: each
    ``tables/group_d{D}`` shard gathered over the model axis in order,
    every other leaf as it is (it is the same on every rank)."""
    return _map_shards(tree, ctx, lambda x, sharded: (
        ctx.all_gather(x.detach(), ctx.model_axis) if sharded else x))
