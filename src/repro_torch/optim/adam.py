"""Adam / AdamW as an in-place update of a param tree.

Port of ``repro/optim/adam.py`` (``OptState``, ``global_norm``,
``clip_by_global_norm``, ``lr_schedule``, ``init``, ``apply``): the same
formulas and cast points (moments in ``state_dtype``, the update in f32),
and the same dense update of every element of every leaf, embedding
tables included: moments of rows a batch did not touch still decay, and
those rows still move.

Where the reference donates its buffers (``donate_argnums=(0, 1)``), the
port updates in place under ``torch.no_grad()``: the gradients are scaled
by the clip factor, then m, v and the params are written where they lie.
Each leaf is walked in blocks of `CHUNK` elements, so no temporary of a
table's size is ever made (a dlrm0 row space on one card is ~4 GB).

The step counter and the learning rate live on the host (the schedule
depends on the step only), so an update makes no host-device sync.
``sgd`` and ``adafactor`` wait for ROADMAP.md queue 1, item 7.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, List, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.configs.base import OptimizerConfig

CHUNK = 1 << 26        # elements a block of the update (256 MB in f32)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class OptState(NamedTuple):
    step: int                   # updates applied so far
    mu: Any                     # first moment, the params' tree
    nu: Any                     # second moment


def leaves(tree) -> List[torch.Tensor]:
    """The tensors of a tree of dicts, lists and tuples, in JAX's order
    (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def tree_map(fn: Callable, tree):
    """``fn`` over every tensor of ``tree``, keeping its nesting."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def _not_ported(name: str):
    return NotImplementedError(
        f"optimizer {name!r} is not ported to repro_torch yet (ROADMAP.md "
        f"queue 1, item 7); use 'adam' or 'adamw'")


def _chunks(t: torch.Tensor) -> Iterator[torch.Tensor]:
    flat = t.reshape(-1)
    for i in range(0, flat.numel(), CHUNK):
        yield flat[i:i + CHUNK]


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in f32 (a 0-dim
    tensor on the leaves' device)."""
    total = None
    for x in leaves(tree):
        for c in _chunks(x):
            c = c.float()
            sq = torch.dot(c, c)
            total = sq if total is None else total + sq
    if total is None:
        return torch.zeros((), dtype=torch.float32)
    return torch.sqrt(total)


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp_max(max_norm / torch.clamp_min(norm, 1e-9), 1.0)


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float):
    """-> (grads scaled by min(1, max_norm / norm), norm).  f32 leaves are
    scaled in place; others are replaced by scaled f32 copies."""
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)

    def one(g):
        if g.dtype == torch.float32:
            return g.mul_(scale)
        return g.float() * scale

    return tree_map(one, grads), norm


def lr_schedule(cfg: OptimizerConfig, step: int) -> np.float32:
    """Linear warmup to ``cfg.lr``, in f32 as the reference computes it."""
    warm = min(np.float32(1.0),
               np.float32(step + 1) / np.float32(max(cfg.warmup_steps, 1)))
    return np.float32(cfg.lr) * warm


def init(cfg: OptimizerConfig, params) -> OptState:
    """Zero moments of each leaf's shape in ``cfg.state_dtype``."""
    if cfg.name in ("sgd", "adafactor"):
        raise _not_ported(cfg.name)
    dt = _DTYPES[cfg.state_dtype]

    def zeros():
        return tree_map(lambda p: torch.zeros(p.shape, dtype=dt,
                                              device=p.device), params)

    return OptState(0, zeros(), zeros())


def _update(p, g, m, v, *, scale, b1, b2, lr, c1, c2, eps, decay):
    """One block: clip g, then m, v and p, each in place (f32 math; a
    non-f32 moment or param is updated in an f32 copy of the block)."""
    g = g.mul_(scale) if g.dtype == torch.float32 else g.float() * scale
    m32, v32, p32 = (x if x.dtype == torch.float32 else x.float()
                     for x in (m, v, p))
    # the reference's operations in its order, one rounding each (no fused
    # multiply-adds), so m, v and p agree to an ulp or two
    m32.mul_(b1).add_(g * (1 - b1))
    v32.mul_(b2).add_(torch.square(g).mul_(1 - b2))
    denom = torch.div(v32, c2).sqrt_().add_(eps)
    if decay != 1.0:
        p32.mul_(decay)
    p32.sub_(torch.div(m32, c1).mul_(lr).div_(denom))
    for x, x32 in ((m, m32), (v, v32), (p, p32)):
        if x32 is not x:
            x.copy_(x32)


@torch.no_grad()
def apply(cfg: OptimizerConfig, params, grads, state: OptState
          ) -> Tuple[Any, OptState, Dict[str, torch.Tensor]]:
    """One Adam/AdamW step, in place: ``params``, ``state.mu``/``nu`` and
    ``grads`` (scaled by the clip factor) are written where they lie.
    Returns (params, the state at step + 1, {"grad_norm", "lr"})."""
    if cfg.name in ("sgd", "adafactor"):
        raise _not_ported(cfg.name)
    pl, gl = leaves(params), leaves(grads)
    ml, vl = leaves(state.mu), leaves(state.nu)
    if not len(pl) == len(gl) == len(ml) == len(vl):
        raise ValueError(f"params, grads and moments differ in leaves: "
                         f"{len(pl)}, {len(gl)}, {len(ml)}, {len(vl)}")
    norm = global_norm(gl)
    scale = _clip_scale(norm, cfg.grad_clip)
    step = state.step + 1
    lr = lr_schedule(cfg, state.step)
    one = np.float32(1.0)
    c1 = float(one - np.float32(cfg.b1) ** np.float32(step))
    c2 = float(one - np.float32(cfg.b2) ** np.float32(step))
    decay = float(one - np.float32(cfg.weight_decay) * lr)
    for p, g, m, v in zip(pl, gl, ml, vl):
        if p.shape != g.shape:
            raise ValueError(f"grad {tuple(g.shape)} for param "
                             f"{tuple(p.shape)}")
        if not (p.is_contiguous() and m.is_contiguous()
                and v.is_contiguous()):
            raise ValueError("params and moments must be contiguous (they "
                             "are updated in place)")
        g = g.contiguous()
        for pc, gc, mc, vc in zip(_chunks(p), _chunks(g), _chunks(m),
                                  _chunks(v)):
            _update(pc, gc, mc, vc, scale=scale, b1=cfg.b1, b2=cfg.b2,
                    lr=float(lr), c1=c1, c2=c2, eps=cfg.eps, decay=decay)
    return params, OptState(step, state.mu, state.nu), {
        "grad_norm": norm, "lr": torch.tensor(float(lr))}
