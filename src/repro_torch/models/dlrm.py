"""DLRM0 — the paper's production recommendation workload (§3, Figs 8-10).

Port of ``repro/models/dlrm.py``, single device: scoring and training.
Sparse stack (SparseCore): `EmbeddingCollection.lookup` — the fused
one-launch descriptor lookup by default, or one gather per table with
``fused=False``.  Dense stack (TensorCore): bottom MLP over the dense
features, concatenation with the embeddings, top MLP to one logit; it
computes in bf16, as the reference does, and returns f32 logits.

Params keep the reference's layout (``tables`` -> row spaces, ``bottom``
and ``top`` -> lists of ``{"w", "b"}``), so JAX weights come over through
``repro_torch.interop``.  `loss_fn` is differentiable end to end: on both
routes the table gradients come from the fused-scatter kernel
(``kernels/ops.FusedLookup``, ``kernels/ops.GatherRows``);
``launch/steps.make_train_step`` and ``train/trainer.Trainer`` train on
the route that ``ParallelConfig.emb_pipeline`` picks.

Under a ranked ``ParallelContext`` (a mesh of (data, model) ranks, one
process a rank) the tables follow ``collection_for(cfg, model size)``:
rank (d, m) holds shard m of each ``group_d{D}`` row space and every
``local_d{D}`` whole (`init_params`), and the batch a rank is given is
its own samples, the global batch split over (data, model) in rank
order.  Its sparse stage exchanges ids and vectors with the other ranks
of its model axis (``EmbeddingCollection.lookup``); its dense stage
takes the same samples.  `loss_fn` is then the mean over the GLOBAL
batch; its gradient on a rank is that rank's samples' share, which
``launch/steps`` sums over the ranks (the reference repeats the dense
stage over the model axis instead: the same function).
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, List, Optional

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.embeddings.engine import EmbeddingCollection, row_sharded
from repro_torch.parallel.context import LOCAL, ParallelContext, exchanged


@functools.lru_cache(maxsize=8)
def collection_for(cfg: ModelConfig, num_shards: int = 1
                   ) -> EmbeddingCollection:
    # pipeline-v2 layout: locally-resident tables live in one fused
    # descriptor-addressed row space per width.  One collection per config
    # (cached), so its descriptor plans are built once, not every batch.
    return EmbeddingCollection(cfg.dlrm.tables, num_shards,
                               fused_storage=True)


def _mlp_init(gen: torch.Generator, dims, in_dim, device):
    """Truncated normal on [-2, 2] / sqrt(fan_in) weights, zero biases."""
    params = []
    prev = in_dim
    for h in dims:
        w = torch.empty((prev, h), dtype=torch.float32, device=device)
        torch.nn.init.trunc_normal_(w, a=-2.0, b=2.0, generator=gen)
        params.append({"w": w.div_(math.sqrt(prev)),
                       "b": torch.zeros((h,), dtype=torch.float32,
                                        device=device)})
        prev = h
    return params


def _mlp_apply(params, x, final_linear: bool = True):
    n = len(params)
    for i, lyr in enumerate(params):
        x = x @ lyr["w"].to(x.dtype) + lyr["b"].to(x.dtype)
        if i < n - 1 or not final_linear:
            x = torch.relu(x)
    return x


def init_params(cfg: ModelConfig, gen: torch.Generator,
                num_shards: int = 1, *, device=None,
                ctx: ParallelContext = LOCAL) -> Dict[str, Any]:
    """f32 params on ``device`` (default: ``gen``'s; other draws than the
    reference's, same distributions).

    Under a ranked ``ctx`` the layout is ``collection_for(cfg,
    ctx.model_axis_size)`` and the tables are this rank's: shard m of each
    ``group_d{D}``, every ``local_d{D}`` whole.  The shards are slices of
    the one-device init of that layout, bit for bit: every rank draws each
    whole row space from ``gen``, as one device does, keeps its rows and
    frees the rest before drawing the next (so a row space is held whole
    only while it is drawn)."""
    d = cfg.dlrm
    dev = gen.device if device is None else device
    sharded = ctx.has_mesh and ctx.model_axis_size > 1
    if sharded:
        num_shards = ctx.model_axis_size
    coll = collection_for(cfg, num_shards)
    inter_dim = d.bottom_mlp[-1] + sum(t.dim for t in d.tables)
    keep = None
    if sharded:
        m, ms = ctx.axis_index(ctx.model_axis), ctx.model_axis_size

        def keep(name, t):
            if not row_sharded(name):
                return t
            rps = t.shape[0] // ms
            return t[m * rps:(m + 1) * rps].clone()
    return {
        "tables": coll.init(gen, dev, keep=keep),
        "bottom": _mlp_init(gen, d.bottom_mlp, d.dense_features, dev),
        "top": _mlp_init(gen, d.top_mlp, inter_dim, dev),
    }


def sharded_leaves(params, ctx: ParallelContext = LOCAL) -> List[bool]:
    """In ``OPT.leaves(params)`` order: True for each leaf a rank holds a
    shard of (the ``group_d{D}`` row spaces under a ranked ``ctx`` with
    more than one model rank), False for a leaf every rank holds whole."""
    ms = ctx.model_axis_size if ctx.has_mesh else 1

    def walk(t, sharded):
        if isinstance(t, dict):
            return [x for k in sorted(t)
                    for x in walk(t[k], sharded or row_sharded(k))]
        if isinstance(t, (list, tuple)):
            return [x for v in t for x in walk(v, sharded)]
        return [sharded and ms > 1]
    return walk(params, False)


def sparse_forward(cfg: ModelConfig, p, batch,
                   ctx: ParallelContext = LOCAL, *,
                   coll: Optional[EmbeddingCollection] = None,
                   method: str = "auto", fused: Optional[bool] = None,
                   cache=None) -> torch.Tensor:
    """SC side: concatenated per-table embeddings (B, sum_dims) in bf16.
    ``fused=None`` follows ``ctx.emb_pipeline``; ``cache`` threads a
    ``HotIdCache`` into the a2a path."""
    coll = coll or collection_for(cfg, ctx.model_axis_size)
    feats = {t.name: batch[f"cat_{t.name}"] for t in cfg.dlrm.tables}
    emb = coll.lookup(p["tables"], feats, ctx, method=method, fused=fused,
                      cache=cache)
    # one concatenation, then one cast: the values of casting each table
    # to bf16 first, as the reference does
    return torch.cat([emb[t.name] for t in cfg.dlrm.tables],
                     dim=-1).to(torch.bfloat16)


def dense_forward(cfg: ModelConfig, p, batch, sparse_vec) -> torch.Tensor:
    """TC side: bottom MLP + interaction + top MLP -> logits (B,) f32."""
    x = batch["dense"].to(torch.bfloat16)
    bot = _mlp_apply(p["bottom"], x, final_linear=False)
    inter = torch.cat([bot, sparse_vec], dim=-1)
    logit = _mlp_apply(p["top"], inter, final_linear=True)
    return logit[..., 0].float()


def forward(cfg: ModelConfig, p, batch, ctx: ParallelContext = LOCAL, *,
            coll: Optional[EmbeddingCollection] = None,
            method: str = "auto", fused: Optional[bool] = None,
            cache=None, **_):
    """-> (logits (B,) f32, aux loss 0.0), as the reference: this rank's
    samples under a ranked ``ctx``."""
    logits = dense_forward(cfg, p, batch, sparse_forward(
        cfg, p, batch, ctx, coll=coll, method=method, fused=fused,
        cache=cache))
    return logits, torch.zeros((), dtype=torch.float32, device=logits.device)


def loss_fn(cfg: ModelConfig, p, batch, ctx: ParallelContext = LOCAL, *,
            coll: Optional[EmbeddingCollection] = None,
            method: str = "auto", fused: Optional[bool] = None, cache=None):
    """Mean binary cross-entropy on the logits -> (loss, aux 0.0).
    Differentiable with respect to every param through either lookup
    route: ``ops.FusedLookup`` (``fused=True``) or ``ops.GatherRows``
    (``fused=False``), each with the fused-scatter kernel as its backward
    on the card.

    Under a ranked ``ctx``: the mean over the global batch, the same value
    on every rank (the ranks' sums of their samples' losses, summed).  Its
    backward starts from this rank's sum only (the sum's transpose is the
    identity here: the value is one scalar replicated, not one a rank),
    so a rank's gradient is its samples' share of the global one."""
    logits, aux = forward(cfg, p, batch, ctx, coll=coll, method=method,
                          fused=fused, cache=cache)
    labels = batch["labels"].float()
    per = (torch.clamp_min(logits, 0) - logits * labels
           + torch.log1p(torch.exp(-logits.abs())))
    if not ctx.has_mesh:
        return torch.mean(per), aux
    local = per.sum()
    total = exchanged(local, ctx.all_reduce(local.detach(), async_op=True),
                      lambda g: g)
    return total / (per.shape[0] * ctx.batch_shards), aux


def batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """name -> (shape, dtype) of every model input of this cell."""
    B = shape.global_batch
    out: Dict[str, Any] = {
        "dense": ((B, cfg.dlrm.dense_features), torch.float32),
    }
    for t in cfg.dlrm.tables:
        out[f"cat_{t.name}"] = ((B, t.max_valency), torch.int32)
    if shape.kind == "train":
        out["labels"] = ((B,), torch.int32)
    return out


def make_batch(cfg: ModelConfig, shape: ShapeConfig,
               gen: torch.Generator) -> Dict[str, Any]:
    """Zipf-like categorical ids with valency padding (synthetic), drawn
    from ``gen`` on its device: ids ``u**2 * vocab`` for u uniform in
    [1e-6, 1), each column live with probability avg/max valency, column 0
    always live, -1 padding."""
    B = shape.global_batch
    dev = gen.device
    out = {"dense": torch.randn((B, cfg.dlrm.dense_features), generator=gen,
                                device=dev),
           "labels": (torch.rand((B,), generator=gen, device=dev) < 0.3
                      ).to(torch.int32)}
    for t in cfg.dlrm.tables:
        shp = (B, t.max_valency)
        u = torch.rand(shp, generator=gen, device=dev) * (1.0 - 1e-6) + 1e-6
        ids = torch.clamp_max(u * u * t.vocab_size,
                              t.vocab_size - 1).to(torch.int32)
        keep_p = min(1.0, t.avg_valency / max(t.max_valency, 1))
        live = torch.rand(shp, generator=gen, device=dev) < keep_p
        live[:, 0] = True                    # at least one value
        out[f"cat_{t.name}"] = torch.where(live, ids, -1)
    return out
