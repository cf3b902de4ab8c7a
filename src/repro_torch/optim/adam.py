"""The reference's optimizers (Adam / AdamW, SGD, Adafactor) as in-place
updates of a param tree.

Port of ``repro/optim/adam.py`` (``OptState``, ``global_norm``,
``clip_by_global_norm``, ``lr_schedule``, ``init``, ``apply``): the same
formulas, state layout and cast points (moments in ``state_dtype``, the
update in f32), and the same dense update of every element of every leaf,
embedding tables included: moments of rows a batch did not touch still
decay, and those rows still move.
  * adam / adamw: ``mu`` and ``nu`` are the params' tree;
  * sgd: momentum 0.9 in ``mu`` (``nu`` None), p -= lr x m, no weight
    decay;
  * adafactor: no first moment (``mu`` None); ``nu`` holds, per leaf,
    ``{"v"}`` of its shape for a leaf of rank < 2, else ``{"vr", "vc"}``,
    the second moment factored over the last two dims (row and column
    means of g^2 + 1e-30), with ``weight_decay``.

Where the reference donates its buffers (``donate_argnums=(0, 1)``), the
port updates in place under ``torch.no_grad()``: the gradients are scaled
by the clip factor, then the state and the params are written where they
lie, one rounding per operation, in the reference's order.  Each leaf is
walked in blocks of at most `CHUNK` elements (adafactor: over its leading
dims, then over rows of a matrix larger than a block), so no temporary of
a table's or a stacked expert leaf's size is ever made (a dlrm0 row space
on one card is ~4 GB, qwen3-moe's (L, 128, 2048, 768) expert leaves 3.2 GB
at four layers).

The step counter and the learning rate live on the host (the schedule
depends on the step only), so an update makes no host-device sync.
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


def _chunks(t: torch.Tensor) -> Iterator[torch.Tensor]:
    flat = t.reshape(-1)
    for i in range(0, flat.numel(), CHUNK):
        yield flat[i:i + CHUNK]


def global_norm(tree, ctx=None, sharded=None) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in f32 (a 0-dim
    tensor on the leaves' device).

    Under a ranked context ``ctx`` with ``sharded`` (a bool a leaf, in
    `leaves` order: True where each rank of the model axis holds a
    different shard), the shards' squares are summed over the model axis
    and every other leaf, the same on every rank, counts once: the norm
    of the whole tree, as one device computes it (in another order)."""
    total = shard = None
    flags = sharded or [False] * len(leaves(tree))
    for x, s in zip(leaves(tree), flags):
        for c in _chunks(x):
            c = c.float()
            sq = torch.dot(c, c)
            if s:
                shard = sq if shard is None else shard + sq
            else:
                total = sq if total is None else total + sq
    if shard is not None:
        shard = ctx.all_reduce(shard, ctx.model_axis)
        total = shard if total is None else total + shard
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
    """Zero state for ``cfg.name``, on each leaf's device: adam's moments
    (and sgd's momentum) of each leaf's shape in ``cfg.state_dtype``;
    adafactor's f32 factors (`OptState` docs in the module)."""
    dt = _DTYPES[cfg.state_dtype]

    def zeros(shape, like, dtype=dt):
        return torch.zeros(shape, dtype=dtype, device=like.device)

    def moments():
        return tree_map(lambda p: zeros(p.shape, p), params)

    if cfg.name == "sgd":
        return OptState(0, moments(), None)
    if cfg.name == "adafactor":
        f32 = torch.float32

        def facts(p):
            if p.dim() < 2:
                return {"v": zeros(p.shape, p, f32)}
            return {"vr": zeros(p.shape[:-1], p, f32),
                    "vc": zeros(p.shape[:-2] + p.shape[-1:], p, f32)}

        return OptState(0, None, tree_map(facts, params))
    return OptState(0, moments(), moments())


def _scaled(g, scale):
    """A block of the gradient times the clip factor: in place for f32,
    else an f32 copy."""
    return g.mul_(scale) if g.dtype == torch.float32 else g.float() * scale


def _f32(x):
    return x if x.dtype == torch.float32 else x.float()


def _write_back(pairs):
    for x, x32 in pairs:
        if x32 is not x:
            x.copy_(x32)


def _update(p, g, m, v, *, scale, b1, b2, lr, c1, c2, eps, decay):
    """One Adam block: clip g, then m, v and p, each in place (f32 math; a
    non-f32 moment or param is updated in an f32 copy of the block)."""
    g = _scaled(g, scale)
    m32, v32, p32 = _f32(m), _f32(v), _f32(p)
    # the reference's operations in its order, one rounding each (no fused
    # multiply-adds), so m, v and p agree to an ulp or two
    m32.mul_(b1).add_(g * (1 - b1))
    v32.mul_(b2).add_(torch.square(g).mul_(1 - b2))
    denom = torch.div(v32, c2).sqrt_().add_(eps)
    if decay != 1.0:
        p32.mul_(decay)
    p32.sub_(torch.div(m32, c1).mul_(lr).div_(denom))
    _write_back(((m, m32), (v, v32), (p, p32)))


def _sgd_update(p, g, m, *, scale, lr):
    """One SGD block: m = 0.9 m + g, p -= lr m (the reference's sgd)."""
    g = _scaled(g, scale)
    m32, p32 = _f32(m), _f32(p)
    m32.mul_(0.9).add_(g)
    p32.sub_(torch.mul(m32, lr))
    _write_back(((m, m32), (p, p32)))


def _adafactor_vector(p, g, v, *, scale, b2, lr, eps, decay):
    """One adafactor block of a leaf of rank < 2 (its own second moment)."""
    g = _scaled(g, scale)
    p32 = _f32(p)
    v.mul_(b2).add_(torch.square(g).add_(1e-30).mul_(1 - b2))
    upd = torch.add(v, eps).rsqrt_().mul_(g)
    if decay != 1.0:
        p32.mul_(decay)
    p32.sub_(upd.mul_(lr))
    _write_back(((p, p32),))


def _matrix_blocks(n: int, rows: int, cols: int):
    """(matrices, rows) slices of an (n, rows, cols) leaf, at most `CHUNK`
    elements each where a row fits: whole matrices while one fits, else
    one matrix's rows in runs."""
    if rows * cols <= CHUNK:
        per = max(1, CHUNK // (rows * cols))
        for i in range(0, n, per):
            yield slice(i, min(i + per, n)), slice(0, rows)
    else:
        per = max(1, CHUNK // cols)
        for i in range(n):
            for r in range(0, rows, per):
                yield slice(i, i + 1), slice(r, min(r + per, rows))


def _adafactor_matrix(p, g, vr, vc, *, scale, b2, lr, eps, decay):
    """Adafactor on a leaf of rank >= 2, viewed as (n, rows, cols) over its
    leading dims: a first pass of blocks clips g and updates the row
    factor vr (the mean of g^2 + 1e-30 over a row) and sums the columns;
    the column factor vc then takes the column means; a second pass
    updates p by g / sqrt(vr vc / mean(vr) + eps)."""
    rows, cols = p.shape[-2], p.shape[-1]
    n = p.numel() // (rows * cols)
    p3, g3 = p.view(n, rows, cols), g.view(n, rows, cols)
    vr2, vc2 = vr.view(n, rows), vc.view(n, cols)
    colsum = torch.zeros((n, cols), dtype=torch.float32, device=p.device)
    f32_g = g.dtype == torch.float32
    for ns, rs in _matrix_blocks(n, rows, cols):
        g2 = torch.square(_scaled(g3[ns, rs], scale)).add_(1e-30)
        vr2[ns, rs].mul_(b2).add_(g2.sum(-1).div_(cols).mul_(1 - b2))
        colsum[ns].add_(g2.sum(-2))
        del g2
    vc2.mul_(b2).add_(colsum.div_(rows).mul_(1 - b2))
    del colsum
    rmean = vr2.sum(-1).div_(rows).clamp_min_(1e-30)            # (n,)
    for ns, rs in _matrix_blocks(n, rows, cols):
        gs = g3[ns, rs] if f32_g else g3[ns, rs].float() * scale
        upd = torch.mul(vr2[ns, rs, None], vc2[ns, None, :])
        upd.div_(rmean[ns, None, None]).add_(eps).rsqrt_().mul_(gs)
        pb = p3[ns, rs]
        p32 = _f32(pb)
        if decay != 1.0:
            p32.mul_(decay)
        p32.sub_(upd.mul_(lr))
        _write_back(((pb, p32),))


def _factors(params, nu) -> List[Dict[str, torch.Tensor]]:
    """Adafactor's per-leaf factor dicts, in ``leaves(params)`` order."""
    if isinstance(params, dict):
        return [f for k in sorted(params) for f in _factors(params[k],
                                                            nu[k])]
    if isinstance(params, (list, tuple)):
        return [f for p, n in zip(params, nu) for f in _factors(p, n)]
    return [nu]


def _check_leaf(p, g, *state) -> torch.Tensor:
    if p.shape != g.shape:
        raise ValueError(f"grad {tuple(g.shape)} for param {tuple(p.shape)}")
    if not all(x.is_contiguous() for x in (p,) + state):
        raise ValueError("params and optimizer state must be contiguous "
                         "(they are updated in place)")
    return g.contiguous()


@torch.no_grad()
def apply(cfg: OptimizerConfig, params, grads, state: OptState, *,
          ctx=None, sharded=None
          ) -> Tuple[Any, OptState, Dict[str, torch.Tensor]]:
    """One step of ``cfg.name``, in place: ``params``, the state's tensors
    and ``grads`` (scaled by the clip factor) are written where they lie.
    ``grads``: the params' tree, or its leaves in ``leaves(params)``
    order.  ``ctx`` and ``sharded``: a rank's shards, as `global_norm`
    takes them, so the clip is the one-device clip.  Returns (params, the
    state at step + 1, {"grad_norm", "lr"})."""
    pl, gl = leaves(params), leaves(grads)
    if cfg.name == "adafactor":
        sl = [_factors(params, state.nu)]
    elif cfg.name == "sgd":
        sl = [leaves(state.mu)]
    else:
        sl = [leaves(state.mu), leaves(state.nu)]
    if not all(len(x) == len(pl) for x in [gl] + sl):
        raise ValueError(f"params, grads and state differ in leaves: "
                         f"{len(pl)}, {len(gl)}, "
                         f"{', '.join(str(len(x)) for x in sl)}")
    norm = global_norm(gl, ctx, sharded)
    scale = _clip_scale(norm, cfg.grad_clip)
    step = state.step + 1
    lr = lr_schedule(cfg, state.step)
    one = np.float32(1.0)
    decay = float(one - np.float32(cfg.weight_decay) * lr)
    if cfg.name == "sgd":
        for p, g, m in zip(pl, gl, *sl):
            g = _check_leaf(p, g, m)
            for pc, gc, mc in zip(_chunks(p), _chunks(g), _chunks(m)):
                _sgd_update(pc, gc, mc, scale=scale, lr=float(lr))
        new = OptState(step, state.mu, None)
    elif cfg.name == "adafactor":
        kw = dict(scale=scale, b2=cfg.b2, lr=float(lr), eps=cfg.eps,
                  decay=decay)
        for p, g, f in zip(pl, gl, *sl):
            if p.dim() < 2:
                g = _check_leaf(p, g, f["v"])
                for pc, gc, vc in zip(_chunks(p), _chunks(g),
                                      _chunks(f["v"])):
                    _adafactor_vector(pc, gc, vc, **kw)
            else:
                g = _check_leaf(p, g, f["vr"], f["vc"])
                _adafactor_matrix(p, g, f["vr"], f["vc"], **kw)
        new = OptState(step, None, state.nu)
    else:
        c1 = float(one - np.float32(cfg.b1) ** np.float32(step))
        c2 = float(one - np.float32(cfg.b2) ** np.float32(step))
        for p, g, m, v in zip(pl, gl, *sl):
            g = _check_leaf(p, g, m, v)
            for pc, gc, mc, vc in zip(_chunks(p), _chunks(g), _chunks(m),
                                      _chunks(v)):
                _update(pc, gc, mc, vc, scale=scale, b1=cfg.b1, b2=cfg.b2,
                        lr=float(lr), c1=c1, c2=c2, eps=cfg.eps,
                        decay=decay)
        new = OptState(step, state.mu, state.nu)
    return params, new, {"grad_norm": norm, "lr": torch.tensor(float(lr))}
