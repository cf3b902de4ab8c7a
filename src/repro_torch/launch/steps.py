"""The train step (port of ``repro/launch/steps.py``).

``make_train_step`` builds the step `Trainer` runs: the loss and its
gradient with respect to detached views of the params (so the params
themselves never require a gradient), a backward that adds each
microbatch's share straight into the f32 accumulator (`accumulate_grad`,
one microbatch or several), then the in-place optimizer update.  The
metrics dict has the reference's keys.  A decoder's loss (the dense, MoE,
SSM and hybrid families) is the token cross-entropy, whole or chunked
(``ParallelConfig.xent_chunk``), plus 0.01 x the MoE load-balance loss,
with per-layer remat; the DLRM's is its BCE.

Under a ranked ``ParallelContext`` (``parallel/context.py``) the step
follows the reference's rule.  Where the batch axes hold more than one
rank, the model axis one, and the global batch splits into the ranks'
microbatches, each rank takes the gradient of its own samples on one
device (``LOCAL``) and the ranks exchange it through
``parallel/compression.compressed_allreduce``: the plain mean for
``grad_compression="none"`` (the decoder families) or the compressed one
(every family); the metrics are averaged over the ranks, so every
replica takes the same update.  Otherwise the DLRM trains over its
(data, model) grid of ranks: each rank takes its own samples through the
sparse and the dense stage, the loss is the mean over the global batch,
and after the backward the gradients are summed: a ``group_d{D}``
shard's (which the exchange's backward has already brought from the
ranks of its model axis) over the data axis, every other leaf over all
ranks; a compression scheme is then the one-device round trip, as it is
on one device.  Adam's global norm counts each shard once
(``optim/adam.global_norm``).  A decoder with a model axis over one rank
(tensor or FSDP sharding) waits for ROADMAP.md queue 1, item 12(b).

Not ported yet: the serving step functions.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import (ModelConfig, OptimizerConfig,
                                      ParallelConfig, ShapeConfig)
from repro_torch.models import api
from repro_torch.models import transformer as TF
from repro_torch.optim import adam as OPT
from repro_torch.parallel import compression as COMP
from repro_torch.parallel.context import LOCAL, ParallelContext


def _xent(logits, labels):
    """Token cross-entropy; logits f32 (B, T, V), labels (B, T)."""
    lse = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, labels.long()[..., None])[..., 0]
    return (lse - ll).mean()


def _chunk_xent_sum(cfg: ModelConfig, params, xb, lb):
    """Summed cross-entropy of one sequence chunk: its (B, chunk, V) f32
    logits exist only inside this call."""
    logits = TF.unembed(cfg, params, xb)
    lse = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, lb.long()[..., None])[..., 0]
    return (lse - ll).sum()


def _xent_chunked(cfg: ModelConfig, params, x, labels, chunk: int):
    """Sequence-chunked cross-entropy (the reference's ``lax.scan`` over
    chunks, summed in the same order): the (B, T, V) logits never exist at
    once.  x: final hidden states (B, T, D); labels (B, T).

    When a gradient is recorded each chunk's logits are recomputed in the
    backward pass (``torch.utils.checkpoint``), so the graph keeps no
    chunk's (B, chunk, V) f32 logits alive between the forward and the
    backward."""
    B, T, D = x.shape
    chunk = min(chunk, T)
    if T % chunk:
        chunk = T  # fall back (shapes in this repo are powers of two)
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, T, chunk):
        xb, lb = x[:, c0:c0 + chunk], labels[:, c0:c0 + chunk]
        if torch.is_grad_enabled():
            s = torch.utils.checkpoint.checkpoint(
                _chunk_xent_sum, cfg, params, xb, lb, use_reentrant=False)
        else:
            s = _chunk_xent_sum(cfg, params, xb, lb)
        tot = tot + s
    return tot / (B * T)


def loss_fn(cfg: ModelConfig, params, batch,
            pcfg: ParallelConfig = ParallelConfig(),
            ctx: ParallelContext = LOCAL
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """-> (loss, metrics).

    Dense, MoE, SSM and hybrid: token cross-entropy of the teacher-forced
    `api.forward` plus 0.01 x aux (the MoE layers' load-balance losses
    summed; 0 for the other families), with ``pcfg.remat`` ("none" or
    per-layer recompute), ``pcfg.attn_impl`` and, when ``pcfg.xent_chunk``
    is set, the chunked cross-entropy over the final hidden states;
    metrics ``loss`` (the cross-entropy) and ``aux``.  A MoE layer's
    capacity counts the tokens of the batch it is given (a microbatch
    under accumulation), as the reference's.

    DLRM: the mean BCE, through the lookup route ``pcfg.emb_pipeline``
    picks (the reference's ``ctx.emb_pipeline``: fused by default, per
    table when off), over ``ctx``'s ranks (``batch``: this rank's
    samples)."""
    if cfg.family == "dlrm":
        from repro_torch.models import dlrm as DL
        loss, _ = DL.loss_fn(cfg, params, batch, ctx,
                             fused=pcfg.emb_pipeline)
        return loss, {"loss": loss}
    _one_device(cfg, ctx)
    if cfg.family not in TF.DECODER_FAMILIES:
        raise NotImplementedError(
            f"training the {cfg.family!r} family waits for ROADMAP.md "
            f"queue 1, item 11(i)")
    labels = batch["labels"]
    fwd = {k: v for k, v in batch.items() if k != "labels"}
    T = labels.shape[1]
    kw = dict(remat=pcfg.remat != "none", attn_impl=pcfg.attn_impl)
    if pcfg.xent_chunk:
        x, aux = api.forward(cfg, params, fwd, return_hidden=True, **kw)
        ce = _xent_chunked(cfg, params, x[:, -T:, :], labels,
                           pcfg.xent_chunk)
    else:
        logits, aux = api.forward(cfg, params, fwd, **kw)
        ce = _xent(logits[:, -T:, :], labels)
    return ce + 0.01 * aux, {"loss": ce, "aux": aux}


def pick_accum_steps(cfg: ModelConfig, shape: ShapeConfig,
                     ctx: ParallelContext = LOCAL, *,
                     logits_budget: int = 256 << 20,
                     xent_chunk: int = 0) -> int:
    """Accumulation steps so per-device microbatch logits stay bounded
    (every rank of ``ctx``'s mesh shares the batch)."""
    if cfg.family == "dlrm":
        return 1
    ndev = ctx.mesh.size() if ctx.mesh is not None else 1
    eff_seq = min(xent_chunk, shape.seq_len) if xent_chunk else shape.seq_len
    bytes_per_sample = eff_seq * cfg.vocab_size * 4
    total = shape.global_batch * bytes_per_sample
    accum = 1
    while (total / (accum * ndev)) > logits_budget \
            and accum < shape.global_batch:
        accum *= 2
    while shape.global_batch % accum:
        accum //= 2
    return max(accum, 1)


def _one_device(cfg: ModelConfig, ctx: ParallelContext) -> None:
    if ctx.has_mesh:
        raise NotImplementedError(
            f"the {cfg.family!r} family's loss over several ranks (tensor "
            f"or FSDP sharding) waits for ROADMAP.md queue 1, item 12(b); "
            f"data-parallel steps take make_train_step on a (n, 1) mesh")


def reduce_grads(cfg: ModelConfig, params, grads: List[torch.Tensor],
                 ctx: ParallelContext = LOCAL) -> List[torch.Tensor]:
    """Sum each rank's share of the gradient (``OPT.leaves`` order, in
    place) into the whole: a sharded leaf's over the data axis, every
    other leaf's over all ranks.  The identity off a mesh."""
    if not ctx.has_mesh:
        return grads
    from repro_torch.models import dlrm as DL
    for g, sharded in zip(grads, DL.sharded_leaves(params, ctx)):
        ctx.all_reduce_(g, ctx.data_axis if sharded else None)
    return grads


def value_and_grad(cfg: ModelConfig, pcfg: ParallelConfig, params, batch,
                   ctx: ParallelContext = LOCAL
                   ) -> Tuple[Dict[str, torch.Tensor], List[torch.Tensor]]:
    """(metrics of `loss_fn`, f32 gradients in ``OPT.leaves(params)``
    order): `accumulate_grad` at scale 1 into a fresh accumulator, the
    path every train step takes, then `reduce_grads` over ``ctx``'s
    ranks.  ``params`` never require a gradient: a tree handed to the
    serving engine records no graph."""
    grads: List[Optional[torch.Tensor]] = [None] * len(OPT.leaves(params))
    metrics = accumulate_grad(cfg, pcfg, params, batch, grads, 1.0, ctx)
    return metrics, reduce_grads(cfg, params, grads, ctx)


def _view(p, a, i, late):
    """A detached view of ``p`` that requires a gradient, with ``a`` (its
    accumulator slice) as its ``.grad`` where both are f32; otherwise
    (view, ``a``, or ``i`` when ``a`` is None) goes on ``late``."""
    v = p.detach().requires_grad_(True)
    if a is not None and p.dtype == torch.float32:
        v.grad = a
    else:
        late.append((v, i if a is None else a))
    return v


def _views_into(t, s, acc: List[Optional[torch.Tensor]], index, late):
    """Detached views of the param leaves of ``t`` (same storage) that
    require a gradient, each with its entry of the accumulator ``acc``
    (f32, in ``OPT.leaves`` order; ``index`` counts the leaves) as its
    ``.grad`` where both are f32, so autograd adds into it in place.  A
    leaf the model stacks by layer (True in ``s``, from `api.stacked`)
    becomes the list of its per-layer views, each with its slice of the
    accumulator (allocated here when its entry is None), so each layer's
    gradient lands the moment autograd has it, with no gradient of the
    whole stack in between.  An unstacked leaf whose entry is None keeps
    no ``.grad``: autograd hands it its own gradient, with no zeroed
    buffer beside it.  ``late`` collects the views `accumulate_grad`
    finishes after the backward.  (Module-level, not a closure: a
    recursive closure is a reference cycle, which would keep the views,
    and their gradients, alive until the next garbage collection.)"""
    if isinstance(t, dict):
        return {k: _views_into(t[k], s[k], acc, index, late)
                for k in sorted(t)}
    if isinstance(t, (list, tuple)):
        return type(t)(_views_into(v, f, acc, index, late)
                       for v, f in zip(t, s))
    i = next(index)
    if not s:
        return _view(t, acc[i], i, late)
    if acc[i] is None:
        acc[i] = torch.zeros(t.shape, dtype=torch.float32, device=t.device)
    return [_view(t[l], acc[i][l], i, late) for l in range(t.shape[0])]


def accumulate_grad(cfg: ModelConfig, pcfg: ParallelConfig, params, batch,
                    acc: List[Optional[torch.Tensor]], scale: float,
                    ctx: ParallelContext = LOCAL
                    ) -> Dict[str, torch.Tensor]:
    """Adds ``scale`` x the gradient of `loss_fn` into ``acc`` (f32, in
    ``OPT.leaves(params)`` order; an entry that is None is filled with the
    leaf's share) in place, each leaf's share as autograd finishes it (the
    views' ``.grad`` are ``acc``'s slices), and returns the metrics.  The
    backward starts from ``scale``, so for a power of two each share is
    the gradient divided by ``1 / scale`` bit for bit, and the sum is the
    reference's ``acc + g / accum``; the memory is the accumulator's and
    one layer's gradient, not a whole second gradient."""
    late: List[Tuple[torch.Tensor, Any]] = []
    views = _views_into(params, api.stacked(cfg, params), acc,
                        iter(range(len(acc))), late)
    loss, metrics = loss_fn(cfg, views, batch, pcfg, ctx)
    torch.autograd.backward(loss, torch.full_like(loss, scale))
    for v, a in late:
        g = v.grad if v.grad is not None else torch.zeros_like(v)
        if isinstance(a, int):
            acc[a] = g.float()
        else:
            a.add_(g.float())
    return {k: v.detach() for k, v in metrics.items()}


def _mean_metrics(metrics: Dict, ctx: ParallelContext
                  ) -> Dict[str, torch.Tensor]:
    """Each metric averaged over the data axis, in one collective."""
    keys = list(metrics)
    v = torch.stack([metrics[k].float().reshape(()) for k in keys])
    v = ctx.all_reduce(v, ctx.data_axis) / ctx.axis_size(ctx.data_axis)
    return dict(zip(keys, v.unbind(0)))


def make_train_step(cfg: ModelConfig, shape: ShapeConfig,
                    pcfg: ParallelConfig, ocfg: OptimizerConfig,
                    ctx: ParallelContext = LOCAL, *,
                    accum_steps: Optional[int] = None) -> Callable:
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)`` on the device that holds ``params``; params and optimizer
    state are updated in place.  ``batch``: name -> tensor on that device
    (under a ranked ``ctx``: this rank's samples, ``ctx.local_rows`` of
    the global batch; params and state: this rank's, as
    ``models/dlrm.init_params(ctx=ctx)`` lays them out, and a decoder's
    whole on every rank).  ``pcfg.grad_compression`` picks the exchange
    (see the module doc).  The metrics' ``wire_bytes``,
    ``wire_bytes_full`` and ``wire_overhead_bytes`` are
    ``compression.wire_bytes`` of this rank's gradient leaves."""
    scheme = pcfg.grad_compression
    if scheme not in COMP.SCHEMES:
        raise ValueError(f"grad_compression={scheme!r}: one of "
                         f"{COMP.SCHEMES}")
    decoder = cfg.family != "dlrm"
    if decoder and ctx.model_axis_size > 1:
        _one_device(cfg, ctx)
    accum = accum_steps or pick_accum_steps(cfg, shape, ctx,
                                            xent_chunk=pcfg.xent_chunk)
    ndp = ctx.axis_size(ctx.data_axis)
    # the reference's dp_exchange (and, for the decoders, its plain mean):
    # each rank's gradient on one device, then the exchange
    per_rank = (ndp > 1 and ctx.model_axis_size == 1
                and (scheme != "none" or decoder)
                and shape.global_batch % (ndp * accum) == 0)
    if decoder and ctx.has_mesh and not per_rank:
        raise ValueError(f"a global batch of {shape.global_batch} does not "
                         f"split into {ndp} ranks x {accum} microbatches")
    gctx = LOCAL if per_rank else ctx

    def accumulated(params, batch) -> Tuple[List[torch.Tensor], Dict]:
        acc: List[Optional[torch.Tensor]] = [None] * len(OPT.leaves(params))
        if accum == 1:
            # the microbatch's own metrics, as the reference logs them
            return acc, accumulate_grad(cfg, pcfg, params, batch, acc, 1.0,
                                        gctx)
        B = next(iter(batch.values())).shape[0]
        if B % accum:
            raise ValueError(f"batch {B} is not a multiple of accum_steps "
                             f"{accum}")
        mb = B // accum
        loss = 0.0
        for i in range(accum):
            part = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
            m = accumulate_grad(cfg, pcfg, params, part, acc, 1.0 / accum,
                                gctx)
            # the reference accumulates the loss it differentiates:
            # ce + 0.01 x aux
            total = m["loss"] + 0.01 * m["aux"] if "aux" in m else m["loss"]
            loss = loss + total / accum
        return acc, {"loss": loss}

    def train_step(params, opt_state, batch):
        grads, metrics = accumulated(params, batch)
        sharded = None
        if per_rank:
            grads = COMP.compressed_allreduce(grads, scheme,
                                              ctx.batch_axes, ctx)
            metrics = _mean_metrics(metrics, ctx)
        else:
            reduce_grads(cfg, params, grads, ctx)
            if ctx.has_mesh:
                from repro_torch.models import dlrm as DL
                sharded = DL.sharded_leaves(params, ctx)
            if scheme != "none":
                grads = COMP.compress_grads(grads, scheme)
        metrics = dict(metrics, **{k: float(v) for k, v in
                                   COMP.wire_bytes(grads, scheme).items()})
        # grads is flat in OPT.leaves(params) order, which is the order
        # OPT.apply flattens a tree in
        params, opt_state, om = OPT.apply(ocfg, params, grads, opt_state,
                                          ctx=ctx, sharded=sharded)
        return params, opt_state, dict(metrics, **om)

    return train_step
