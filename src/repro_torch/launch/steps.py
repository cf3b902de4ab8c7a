"""The train step (port of ``repro/launch/steps.py``, one device).

``make_train_step`` builds the step `Trainer` runs: the loss and its
gradient (``torch.autograd.grad``, so no gradient is ever accumulated into
a param's ``.grad``), gradient-accumulation microsteps, then the in-place
optimizer update.  The metrics dict has the reference's keys.

Not ported yet: the dense family's loss (ROADMAP.md slice 4), the
serving step functions, and compressed gradient exchange
(``grad_compression != "none"``, queue 1, item 12).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import (ModelConfig, OptimizerConfig,
                                      ParallelConfig, ShapeConfig)
from repro_torch.optim import adam as OPT


def loss_fn(cfg: ModelConfig, params, batch,
            pcfg: ParallelConfig = ParallelConfig()
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """-> (loss, metrics).  The DLRM's mean BCE, through the lookup route
    ``pcfg.emb_pipeline`` picks (the reference's ``ctx.emb_pipeline``:
    fused by default, per table when off); other families raise."""
    if cfg.family == "dlrm":
        from repro_torch.models import dlrm as DL
        loss, _ = DL.loss_fn(cfg, params, batch, fused=pcfg.emb_pipeline)
        return loss, {"loss": loss}
    raise NotImplementedError(
        f"training the {cfg.family!r} family (its loss, chunked "
        f"cross-entropy and remat) is ROADMAP.md slice 4 (queue 1, item 7)")


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
    The param leaves are marked as requiring a gradient."""
    leaves = OPT.leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss, metrics = loss_fn(cfg, params, batch, pcfg)
    grads = torch.autograd.grad(loss, leaves)
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
