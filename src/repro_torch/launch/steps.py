"""The train step (port of ``repro/launch/steps.py``, one device).

``make_train_step`` builds the step `Trainer` runs: the loss and its
gradient (``torch.autograd.grad`` with respect to detached views of the
params, so the params themselves never require a gradient and nothing is
accumulated into a ``.grad``), gradient-accumulation microsteps, then the
in-place optimizer update.  The metrics dict has the reference's keys.
The dense family's loss is the token cross-entropy, whole or chunked
(``ParallelConfig.xent_chunk``), with per-layer remat.

Not ported yet: the serving step functions, and compressed gradient
exchange (``grad_compression != "none"``, queue 1, item 12).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import (ModelConfig, OptimizerConfig,
                                      ParallelConfig, ShapeConfig)
from repro_torch.models import api
from repro_torch.models import transformer as TF
from repro_torch.optim import adam as OPT


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
            pcfg: ParallelConfig = ParallelConfig()
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """-> (loss, metrics).

    Dense: token cross-entropy of the teacher-forced `api.forward` (plus
    0.01 x aux, 0 for the dense family), with ``pcfg.remat`` ("none" or
    per-layer recompute), ``pcfg.attn_impl`` and, when ``pcfg.xent_chunk``
    is set, the chunked cross-entropy over the final hidden states;
    metrics ``loss`` (the cross-entropy) and ``aux``.

    DLRM: the mean BCE, through the lookup route ``pcfg.emb_pipeline``
    picks (the reference's ``ctx.emb_pipeline``: fused by default, per
    table when off)."""
    if cfg.family == "dlrm":
        from repro_torch.models import dlrm as DL
        loss, _ = DL.loss_fn(cfg, params, batch, fused=pcfg.emb_pipeline)
        return loss, {"loss": loss}
    if cfg.family != "dense":
        raise NotImplementedError(
            f"training the {cfg.family!r} family waits for ROADMAP.md "
            f"queue 1, item 11")
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


def pick_accum_steps(cfg: ModelConfig, shape: ShapeConfig, *,
                     logits_budget: int = 256 << 20, xent_chunk: int = 0,
                     ndev: int = 1) -> int:
    """Accumulation steps so per-device microbatch logits stay bounded
    (``ndev`` devices share the batch; the port runs on one)."""
    if cfg.family == "dlrm":
        return 1
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


def wire_bytes(grads) -> Dict[str, int]:
    """Payload bytes of ONE uncompressed gradient exchange (the reference's
    ``compression.wire_bytes(grads, "none")``)."""
    full = sum(g.numel() * g.element_size() for g in OPT.leaves(grads))
    return {"wire_bytes": full, "wire_overhead_bytes": 0,
            "wire_bytes_full": full}


def value_and_grad(cfg: ModelConfig, pcfg: ParallelConfig, params, batch
                   ) -> Tuple[Dict[str, torch.Tensor], List[torch.Tensor]]:
    """(metrics of `loss_fn`, gradients in ``OPT.leaves(params)`` order).
    The loss is taken of detached views of the param leaves (same
    storage), so ``params`` never require a gradient: a tree handed to the
    serving engine records no graph."""
    views = OPT.tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss, metrics = loss_fn(cfg, views, batch, pcfg)
    grads = torch.autograd.grad(loss, OPT.leaves(views))
    return {k: v.detach() for k, v in metrics.items()}, list(grads)


def make_train_step(cfg: ModelConfig, shape: ShapeConfig,
                    pcfg: ParallelConfig, ocfg: OptimizerConfig, *,
                    accum_steps: Optional[int] = None) -> Callable:
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)`` on the device that holds ``params``; params and optimizer
    state are updated in place.  ``batch``: name -> tensor on that device.
    """
    if pcfg.grad_compression != "none":
        raise NotImplementedError(
            f"grad_compression={pcfg.grad_compression!r}: compressed "
            f"gradient exchange waits for ROADMAP.md queue 1, item 12")
    accum = accum_steps or pick_accum_steps(cfg, shape,
                                            xent_chunk=pcfg.xent_chunk)

    def accumulated(params, batch) -> Tuple[List[torch.Tensor], Dict]:
        if accum == 1:
            metrics, grads = value_and_grad(cfg, pcfg, params, batch)
            return grads, metrics
        B = shape.global_batch
        if B % accum:
            raise ValueError(f"batch {B} is not a multiple of accum_steps "
                             f"{accum}")
        mb = B // accum
        acc: Optional[List[torch.Tensor]] = None
        loss = 0.0
        for i in range(accum):
            part = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
            m, g = value_and_grad(cfg, pcfg, params, part)
            if acc is None:
                acc = [torch.zeros(x.shape, dtype=torch.float32,
                                   device=x.device) for x in g]
            for a, b in zip(acc, g):
                a.add_(b.float() / accum)
            loss = loss + m["loss"] / accum
        return acc, {"loss": loss}

    def train_step(params, opt_state, batch):
        grads, metrics = accumulated(params, batch)
        metrics = dict(metrics, **{k: float(v) for k, v in
                                   wire_bytes(grads).items()})
        # grads is flat in OPT.leaves(params) order, which is the order
        # OPT.apply flattens a tree in
        params, opt_state, om = OPT.apply(ocfg, params, grads, opt_state)
        return params, opt_state, dict(metrics, **om)

    return train_step
