"""The port's data-parallel training path (``repro_torch``'s
``parallel/compression.py``, the exchange in ``launch/steps.py``,
``train/trainer.Trainer`` and ``launch/train.py`` over ranks) against the
JAX package's on the same mesh shapes.

How it runs.  A module fixture starts, at once:
  * the reference: this file as a script with ``XLA_FLAGS=
    --xla_force_host_platform_device_count=4`` and ``JAX_PLATFORMS=cpu``
    (the pytest process has fixed JAX at one device): ``compressed_allreduce``
    in a ``shard_map`` and ``make_train_step`` on mesh (4, 1) of ("data",
    "model"), and ``make_train_step(LOCAL)`` for the one-device curves;
  * the port, each side this file as a script, gloo over a ``FileStore``
    under ``tmp_path`` (no TCP port: xdist runs several workers at once),
    one torch thread a rank: 4 ranks (the exchange and the DP steps on
    (4, 1), a decoder refused on (2, 2), reduced dlrm0's ``Trainer`` on
    (2, 2)); 2 ranks (reduced olmo-1b's ``Trainer`` with int8: replicas,
    preemption, checkpoints); one process (a world of one rank against
    ``LOCAL``, one device accumulating the ranks' pieces, the one-device
    pins); and the CLI on 2 ranks through a ``file://`` init method.
The rank code imports no JAX.  Inputs (gradient trees, params, batches)
come from numpy and torch seeds in this process and go to every side as
one ``.npz``; each side writes its results as ``.npz``.

Bars:
  * ``compress_grads`` int8 and topk, and ``compressed_allreduce`` int8:
    bitwise the reference's (jitted: XLA turns the ``/ 127`` into a
    product with the f32 reciprocal, which the port computes); none and
    topk's exchange within rtol 1e-5 / atol 1e-6 (the sums' order);
    ``tests/spmd_worker.py`` section 7's bars too (int8 within 0.51 x the
    shared scale of the mean, topk the mean of the exact-k tensors);
  * DP steps (reduced olmo-1b none / int8 / topk and hymba-1.5b none, 3
    Adam steps on (4, 1), section 3's shape): each loss within 1e-3 +
    2^-7 |loss| of JAX's and of one device accumulating the same 4
    pieces, the first step's exchanged gradient within 2^-5 of each
    leaf's largest |g| (the training bars of ``tests/test_torch_train.py``),
    the wire metrics equal.  topk keeps what each rank's gradient puts in
    its top 10%: where bf16 rounding reorders elements tied within it at
    the k-th place, a rank keeps another element of about the same
    magnitude, so there the gradient may part by one rank's share; the
    bar holds on all but TOPK_SPLIT_SHARE = 1% of a leaf's elements.
    Against one device, topk's pieces are kept each by its own top k and
    averaged (the top k of the mean is another function);
  * bitwise: the ranks' params after every step, a world of one rank =
    ``LOCAL``, a preempted and resumed ``Trainer`` = an uninterrupted one,
    checkpoints restored (into one process, into the reference's
    ``restore``, onto the grid), the dlrm0 ``Trainer``'s losses = the step
    loop's.
"""
import hashlib
import json
import os
import subprocess
import sys
from datetime import timedelta
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
SCHEMES = ("none", "int8", "topk")
DP_CASES = (("olmo-1b", "none"), ("olmo-1b", "int8"), ("olmo-1b", "topk"),
            ("hymba-1.5b", "none"))
DP_TAGS = tuple(f"{a}_{s}" for a, s in DP_CASES)
DP_SHAPE = ("t", "train", 32, 8)          # spmd_worker.py section 3's
DP_STEPS = 3
OPT = dict(lr=1e-3, warmup_steps=2)
# the one-device pins (tests/test_quantization.py's Trainer cell)
PIN_SHAPE = ("t", "train", 32, 4)
PIN_STEPS = 3
# reduced olmo-1b's Trainer over 2 ranks
TR_SHAPE = ("t", "train", 16, 4)
TR_STEPS, TR_PREEMPT = 4, 2
# reduced dlrm0's Trainer over (2, 2)
DLRM_SHAPE = ("t", "train", 1, 32)
DLRM_STEPS = 3
CLI_STEPS = 3
GRAD_REL_TOL = 2.0 ** -5
TOPK_SPLIT_SHARE = 0.01
AR_RTOL, AR_ATOL = 1e-5, 1e-6
TIMEOUT_S = 240
METRIC_KEYS = {"loss", "aux", "wire_bytes", "wire_bytes_full",
               "wire_overhead_bytes", "grad_norm", "lr", "step", "wall_s"}


# ---------------------------------------------------------------------------
# Shared by every side: trees <-> flat npz keys
# ---------------------------------------------------------------------------

def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}{k}/"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}{i}/"))
        return out
    return {prefix[:-1]: tree}


def _fill(like, flat, prefix):
    """``like``'s tree (its empty dicts too) with each leaf taken from
    ``flat`` under ``prefix`` + the leaf's `_flat` key."""
    if isinstance(like, dict):
        return {k: _fill(v, flat, f"{prefix}{k}/") for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_fill(v, flat, f"{prefix}{i}/")
                          for i, v in enumerate(like))
    return flat[prefix[:-1]]


def _prefixed(d, prefix):
    return {k[len(prefix):]: v for k, v in d.items() if k.startswith(prefix)}


def _batches(flat, tag, n):
    return [{k.split("/", 1)[1]: v for k, v in flat.items()
             if k.startswith(f"{tag}_batch{s}/")} for s in range(n)]


def _ar_tree(flat, r):
    """Rank ``r``'s gradient tree of the exchange cases (numpy)."""
    return {k.split("/", 1)[1]: np.array(v[r]) for k, v in flat.items()
            if k.startswith("ar/")}


def _ar_leaf_dtype(key):
    return "bfloat16" if key == "h" else "float32"


def _split_scale_max():
    """The first x = 1 + i / 1024 where x / 127 and x * f32(1 / 127)
    round to different f32 values."""
    inv = np.float32(1) / np.float32(127)
    return next(x for x in (np.float32(1 + i / 1024) for i in range(1024))
                if x / np.float32(127) != x * inv)


# ---------------------------------------------------------------------------
# Inputs (this process)
# ---------------------------------------------------------------------------

def _make_inputs(path):
    from repro_torch.configs import registry
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.synthetic import Dataset
    from repro_torch.models import api
    rng = np.random.default_rng(21)
    flat = {}
    # the exchange: section 7's (ranks, 256) rows, then a tree with a
    # constant-magnitude leaf (exact k, every entry tied), a leaf under
    # MIN_WIRE_SIZE, a scalar and a bf16 leaf (stored as f32 values that
    # bf16 holds exactly)
    flat["ar/x"] = rng.standard_normal((WORLD, 256)).astype(np.float32)
    flat["ar/a"] = (rng.standard_normal((WORLD, 40, 24)) * 3).astype(
        np.float32)
    flat["ar/c"] = np.where(rng.random((WORLD, 20, 20)) < 0.5, -0.5,
                            0.5).astype(np.float32)
    flat["ar/tiny"] = rng.standard_normal((WORLD, 10)).astype(np.float32)
    flat["ar/s"] = rng.standard_normal((WORLD,)).astype(np.float32)
    h = torch.from_numpy(rng.standard_normal((WORLD, 16, 16)).astype(
        np.float32)).to(torch.bfloat16)
    flat["ar/h"] = h.float().numpy()
    # the shared largest |g| one where x / 127 and x * f32(1 / 127) round
    # apart (the reference's jitted scale is the product)
    flat["ar/m"] = rng.uniform(-1, 1, (WORLD, 24, 24)).astype(np.float32)
    flat["ar/m"][1, 3, 5] = _split_scale_max()
    for arch in sorted({a for a, _ in DP_CASES}):
        cfg = registry.get_reduced(arch)
        p = api.init_params(cfg, seed=7, device="cpu", dtype=torch.float32)
        for k, v in _flat(p).items():
            flat[f"{arch}_p/{k}"] = v.numpy()
        data = Dataset(cfg, ShapeConfig(*DP_SHAPE), seed=3)
        for s in range(DP_STEPS):
            for k, v in data.batch(s).items():
                flat[f"{arch}_batch{s}/{k}"] = v
    cfg = registry.get_reduced("olmo-1b")
    data = Dataset(cfg, ShapeConfig(*PIN_SHAPE), seed=5)
    for s in range(PIN_STEPS):
        for k, v in data.batch(s).items():
            flat[f"pin_batch{s}/{k}"] = v
    np.savez(path, **flat)


# ---------------------------------------------------------------------------
# The reference (a subprocess with 4 host devices)
# ---------------------------------------------------------------------------

def _jax_shapes(cfg):
    import jax
    from repro.models import api as JAPI
    return jax.eval_shape(lambda: JAPI.init_params(cfg,
                                                   jax.random.PRNGKey(0)))


def _reference(inputs, out_path):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=4")
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    import jax.numpy as jnp
    from repro.configs import registry
    from repro.configs.base import (OptimizerConfig, ParallelConfig,
                                    ShapeConfig)
    from repro.launch import steps as STEPS
    from repro.launch.mesh import make_mesh, mesh_scope
    from repro.optim import adam as JOPT
    from repro.parallel import compression as COMP
    from repro.parallel import sharding as SH
    from repro.parallel.context import LOCAL, shard_map
    P = jax.sharding.PartitionSpec

    flat = dict(np.load(inputs))
    res = {}
    # compress_grads, jitted as the train step runs it, on rank 0's tree
    # and on every row of section 7's input
    trees = [{k: jnp.asarray(v, _ar_leaf_dtype(k))
              for k, v in _ar_tree(flat, r).items()} for r in range(WORLD)]
    for scheme in ("int8", "topk"):
        fn = jax.jit(lambda t: COMP.compress_grads(t, scheme))
        for r in range(WORLD):
            out = fn(trees[r])
            res.update({f"cg_{scheme}_{r}/{k}": np.asarray(
                v.astype(jnp.float32)) for k, v in out.items()})
    stacked = {k: jnp.asarray(v, _ar_leaf_dtype(k))
               for k, v in _prefixed(flat, "ar/").items()}
    mesh = make_mesh((WORLD, 1), ("data", "model"))
    for scheme in SCHEMES:
        def body(g):
            return COMP.compressed_allreduce(
                jax.tree.map(lambda x: x[0], g), scheme, ("data",))
        with mesh_scope(mesh):
            out = jax.jit(shard_map(body, mesh=mesh, in_specs=P("data"),
                                    out_specs=P(), check_vma=False))(stacked)
        res.update({f"ar_{scheme}/{k}": np.asarray(v.astype(jnp.float32))
                    for k, v in out.items()})
        wb = COMP.wire_bytes({k: v[0] for k, v in stacked.items()}, scheme)
        res.update({f"wb_{scheme}/{k}": np.asarray(v) for k, v in wb.items()})

    kept = {}
    orig_apply = JOPT.apply

    def apply(ocfg, params, grads, state):
        p, s, om = orig_apply(ocfg, params, grads, state)
        return p, s, dict(om, grads=grads)

    JOPT.apply = apply
    ocfg = OptimizerConfig(**OPT)
    for arch, scheme in DP_CASES:
        tag = f"{arch}_{scheme}"
        cfg = registry.get_reduced(arch)
        shape = ShapeConfig(*DP_SHAPE)
        pcfg = ParallelConfig(remat="block", grad_compression=scheme)
        sctx = SH.make_context(mesh, pcfg)
        params = jax.tree.map(jnp.asarray, _fill(_jax_shapes(cfg), flat,
                                                 f"{arch}_p/"))
        with mesh_scope(mesh):
            _, in_sh, out_sh, step = STEPS.shapes_and_shardings(
                cfg, shape, pcfg, ocfg, sctx)
            to = lambda t: jax.tree.map(
                lambda s: jax.sharding.NamedSharding(mesh, s)
                if s is not None else None, t,
                is_leaf=lambda x: isinstance(x, P) or x is None)
            fn = jax.jit(step, in_shardings=to(in_sh))
            p = jax.device_put(params, to(in_sh[0]))
            o = jax.device_put(JOPT.init(ocfg, params), to(in_sh[1]))
            losses = []
            for s, b in enumerate(_batches(flat, arch, DP_STEPS)):
                b = jax.device_put({k: jnp.asarray(v) for k, v in b.items()},
                                   to(in_sh[2]))
                p, o, m = fn(p, o, b)
                losses.append(float(m["loss"]))
                if s == 0:
                    kept[tag] = jax.tree.map(np.asarray, m["grads"])
                    for k in ("wire_bytes", "wire_bytes_full",
                              "wire_overhead_bytes"):
                        res[f"dp_{tag}/{k}"] = np.asarray(float(m[k]))
        res[f"dp_{tag}/losses"] = np.asarray(losses)
        res.update({f"dp_{tag}/g/{k}": v for k, v in
                    _flat(kept[tag]).items()})

    # the one-device curves the port's are held to
    cfg = registry.get_reduced("olmo-1b")
    params = jax.tree.map(jnp.asarray, _fill(_jax_shapes(cfg), flat,
                                             "olmo-1b_p/"))
    for scheme in ("int8", "topk"):
        step = jax.jit(STEPS.make_train_step(
            cfg, ShapeConfig(*PIN_SHAPE),
            ParallelConfig(remat="none", grad_compression=scheme), ocfg,
            LOCAL))
        p, o, losses = params, JOPT.init(ocfg, params), []
        for b in _batches(flat, "pin", PIN_STEPS):
            p, o, m = step(p, o, {k: jnp.asarray(v) for k, v in b.items()})
            losses.append(float(m["loss"]))
        res[f"pin_{scheme}/losses"] = np.asarray(losses)
    np.savez(out_path, **res)


# ---------------------------------------------------------------------------
# The port (gloo ranks; no JAX)
# ---------------------------------------------------------------------------

def _init_ranks(rank, world, store):
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=TIMEOUT_S))


def _mesh_ctx(shape, **kw):
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel.context import ParallelContext
    return ParallelContext(mesh=make_mesh(
        shape, ("data", "model"), timeout=timedelta(seconds=TIMEOUT_S)),
        **kw)


def _torch_tree(flat, prefix, cfg):
    from repro_torch.models import api
    from repro_torch.optim import adam as TOPT
    return TOPT.tree_map(lambda v: torch.from_numpy(np.array(v)), _fill(
        api.param_shapes(cfg, torch.float32), flat, prefix))


def _refill(tree, it):
    """``tree``'s leaves replaced, in ``OPT.leaves`` order (dict keys
    sorted), by the items of ``it``."""
    if isinstance(tree, dict):
        return {k: _refill(tree[k], it) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_refill(v, it) for v in tree)
    return next(it)


class _FirstGrads:
    """``OPT.apply`` passed through while a copy of the gradients of its
    first call (as the optimizer receives them) is kept in ``kept``."""

    def __init__(self, OPT):
        self.OPT, self.kept = OPT, []

    def __enter__(self):
        self.fn = fn = self.OPT.apply

        def spy(cfg, params, grads, *a, **k):
            if not self.kept:
                self.kept.extend(g.detach().clone()
                                 for g in self.OPT.leaves(grads))
            return fn(cfg, params, grads, *a, **k)
        self.OPT.apply = spy
        return self

    def __exit__(self, *a):
        self.OPT.apply = self.fn


def _digest(tree):
    from repro_torch.optim import adam as TOPT
    h = hashlib.sha256()
    for x in TOPT.leaves(tree):
        if isinstance(x, torch.Tensor):
            h.update(x.detach().reshape(-1).view(torch.uint8).numpy()
                     .tobytes())
        else:
            h.update(str(x).encode())
    return h.hexdigest()


def _dp_run(cfg, scheme, params, batches, ctx, *, accum_steps=None,
            pieces_topk=False):
    """DP_STEPS Adam steps of ``make_train_step``: (losses, the first
    step's gradient in the params' tree, wire metrics, final params).
    ``pieces_topk``: one device, each of the ranks' pieces kept by its own
    top k and averaged (the DP topk exchange's function)."""
    from repro_torch.configs.base import (OptimizerConfig, ParallelConfig,
                                          ShapeConfig)
    from repro_torch.launch import steps as STEPS
    from repro_torch.optim import adam as TOPT
    from repro_torch.parallel import compression as COMP
    shape = ShapeConfig(*DP_SHAPE)
    ocfg = OptimizerConfig(**OPT)
    pcfg = ParallelConfig(remat="block", grad_compression=scheme)
    p = TOPT.tree_map(lambda x: x.clone(), params)
    o = TOPT.init(ocfg, p)
    if pieces_topk:
        piece_cfg = ParallelConfig(remat="block")

        def step(p, o, b):
            mb = shape.global_batch // WORLD
            acc, losses = None, []
            for i in range(WORLD):
                part = {k: v[i * mb:(i + 1) * mb] for k, v in b.items()}
                m, g = STEPS.value_and_grad(cfg, piece_cfg, p, part)
                g = COMP.compress_grads(g, "topk")
                acc = g if acc is None else [a + x for a, x in zip(acc, g)]
                losses.append(m["loss"] + 0.01 * m["aux"])
            acc = [a / WORLD for a in acc]
            p, o, om = TOPT.apply(ocfg, p, acc, o)
            return p, o, dict({"loss": sum(losses) / WORLD},
                              **COMP.wire_bytes(acc, "topk"), **om)
    else:
        step = STEPS.make_train_step(cfg, shape, pcfg, ocfg, ctx,
                                     accum_steps=accum_steps)
    losses, wire = [], {}
    with _FirstGrads(TOPT) as fg:
        for s, b in enumerate(batches):
            p, o, m = step(p, o, b)
            losses.append(float(m["loss"]))
            if s == 0:
                wire = {k: float(m[k]) for k in
                        ("wire_bytes", "wire_bytes_full",
                         "wire_overhead_bytes")}
    g = _refill(TOPT.tree_map(lambda x: None, p), iter(fg.kept))
    return losses, g, wire, p


def _rank(rank, store, inputs, out_path, workdir):
    _init_ranks(rank, WORLD, store)
    from repro_torch.configs import registry
    from repro_torch.configs.base import (OptimizerConfig, ParallelConfig,
                                          RunConfig, ShapeConfig)
    from repro_torch.data.synthetic import Dataset
    from repro_torch.embeddings import sharding as TSH
    from repro_torch.launch import steps as STEPS
    from repro_torch.models import api
    from repro_torch.models import dlrm as TDL
    from repro_torch.optim import adam as TOPT
    from repro_torch.parallel import compression as COMP
    from repro_torch.train.trainer import Trainer

    flat = dict(np.load(inputs))
    res = {}
    ctx = _mesh_ctx((WORLD, 1))
    assert ctx.batch_axes == ("data",)
    # the exchange: this rank's tree in, the mean out (every rank's must
    # be equal: their digests are kept)
    for scheme in SCHEMES:
        tree = {k: torch.from_numpy(v.copy()).to(
            torch.bfloat16 if k == "h" else torch.float32)
            for k, v in _ar_tree(flat, rank).items()}
        out = COMP.compressed_allreduce(tree, scheme, ctx.batch_axes, ctx)
        assert all(out[k].dtype == tree[k].dtype for k in tree)
        res.update({f"ar_{scheme}/{k}": v.float().numpy()
                    for k, v in out.items()})
        res[f"ar_{scheme}/digest"] = np.asarray(_digest(out))

    # the DP steps on (4, 1), each rank on its rows
    for arch, scheme in DP_CASES:
        tag = f"{arch}_{scheme}"
        cfg = registry.get_reduced(arch)
        rows = ctx.local_rows(DP_SHAPE[3])
        mine = [{k: torch.from_numpy(v[rows].copy()) for k, v in b.items()}
                for b in _batches(flat, arch, DP_STEPS)]
        losses, g, wire, p = _dp_run(cfg, scheme,
                                     _torch_tree(flat, f"{arch}_p/", cfg), mine,
                                     ctx)
        res[f"dp_{tag}/losses"] = np.asarray(losses)
        res.update({f"dp_{tag}/{k}": np.asarray(v) for k, v in wire.items()})
        res.update({f"dp_{tag}/g/{k}": v.numpy() for k, v in
                    _flat(g).items()})
        res[f"dp_{tag}/digest"] = np.asarray(_digest(p))

    # a decoder with a model axis over one rank is refused
    ctx22 = _mesh_ctx((2, 2))
    try:
        STEPS.make_train_step(registry.get_reduced("olmo-1b"),
                              ShapeConfig(*DP_SHAPE), ParallelConfig(),
                              OptimizerConfig(), ctx22)
        res["refused"] = np.asarray("")
    except NotImplementedError as e:
        res["refused"] = np.asarray(str(e))

    # reduced dlrm0's Trainer over (2, 2), every table row-sharded: its
    # losses against the step loop over the same grid, and its checkpoint
    # gathered, then restored onto the grid
    old = (TSH.REPLICATE_BYTES, TSH.TABLE_SHARD_BYTES)
    TSH.REPLICATE_BYTES, TSH.TABLE_SHARD_BYTES = 0, 0
    TDL.collection_for.cache_clear()
    try:
        cfg = registry.get_reduced("dlrm0")
        run = RunConfig(model=cfg, shape=ShapeConfig(*DLRM_SHAPE),
                        parallel=ParallelConfig(remat="none"),
                        optimizer=OptimizerConfig(**OPT))
        ckpt = str(Path(workdir) / "dlrm_ckpt")
        tr = Trainer(run, device="cpu", ctx=ctx22, ckpt_dir=ckpt)
        assert any(TDL.sharded_leaves(tr.init_state().params, ctx22))
        state = tr.train(DLRM_STEPS, log_every=1)
        res["dlrm/trainer_losses"] = np.asarray(
            [m["loss"] for m in tr.metrics_log])
        p = api.init_params(cfg, seed=run.seed, device="cpu", ctx=ctx22)
        o = TOPT.init(run.optimizer, p)
        step = STEPS.make_train_step(cfg, run.shape, run.parallel,
                                     run.optimizer, ctx22)
        data, rows = Dataset(cfg, run.shape), ctx22.local_rows(DLRM_SHAPE[3])
        losses = []
        for s in range(DLRM_STEPS):
            b = {k: torch.from_numpy(v[rows].copy())
                 for k, v in data.batch(s).items()}
            p, o, m = step(p, o, b)
            losses.append(float(m["loss"]))
        res["dlrm/loop_losses"] = np.asarray(losses)
        back = Trainer(run, device="cpu", ctx=ctx22, ckpt_dir=ckpt).restore()
        res["dlrm/restored_step"] = np.asarray(back.step)
        res["dlrm/state_digest"] = np.asarray(_digest(
            [state.params, state.opt_state.mu, state.opt_state.nu,
             state.opt_state.step]))
        res["dlrm/restored_digest"] = np.asarray(_digest(
            [back.params, back.opt_state.mu, back.opt_state.nu,
             back.opt_state.step]))
    finally:
        TSH.REPLICATE_BYTES, TSH.TABLE_SHARD_BYTES = old
        TDL.collection_for.cache_clear()
    np.savez(out_path.replace(".npz", f"{rank}.npz"), **res)
    import torch.distributed as dist
    dist.destroy_process_group()


def _tr_run(ckpt_dir, ctx=None):
    from repro_torch.configs import registry
    from repro_torch.configs.base import (OptimizerConfig, ParallelConfig,
                                          RunConfig, ShapeConfig)
    from repro_torch.parallel.context import LOCAL
    from repro_torch.train.trainer import Trainer
    run = RunConfig(model=registry.get_reduced("olmo-1b"),
                    shape=ShapeConfig(*TR_SHAPE),
                    parallel=ParallelConfig(remat="none",
                                            grad_compression="int8"),
                    optimizer=OptimizerConfig(**OPT))
    return Trainer(run, device="cpu", ctx=ctx or LOCAL, ckpt_dir=ckpt_dir)


def _pair(rank, store, out_path, workdir):
    """Reduced olmo-1b with int8 on 2 ranks: replicas after every step, a
    preemption that one rank asks for, and the resume."""
    _init_ranks(rank, 2, store)
    ctx = _mesh_ctx((2, 1))
    res = {}
    whole = _tr_run(str(Path(workdir) / "tr_whole"), ctx)
    digests = []
    state = whole.init_state()
    whole.train(TR_STEPS, state=state, log_every=1,
                on_step=lambda s, _: digests.append(_digest(state.params)))
    res["digests"] = np.asarray(digests)
    res["losses"] = np.asarray([m["loss"] for m in whole.metrics_log])
    res["final"] = np.asarray(_digest(state.params))
    if rank == 0:
        res.update({f"p/{k}": v.numpy() for k, v in
                    _flat(state.params).items()})
        res.update({f"mu/{k}": v.numpy() for k, v in
                    _flat(state.opt_state.mu).items()})
    cut = _tr_run(str(Path(workdir) / "tr_cut"), ctx)
    # only rank 1 asks; both must stop at the same boundary
    first = cut.train(TR_STEPS, log_every=1, on_step=lambda s, _: (
        cut.request_preempt() if s == TR_PREEMPT and rank == 1 else None))
    res["preempted"] = np.asarray([cut.preempted, first.step])
    resumed = _tr_run(str(Path(workdir) / "tr_cut"), ctx)
    last = resumed.train(TR_STEPS, log_every=1)
    res["resumed"] = np.asarray(_digest(last.params))
    res["resumed_opt"] = np.asarray(_digest([last.opt_state.mu,
                                             last.opt_state.nu]))
    res["whole_opt"] = np.asarray(_digest([state.opt_state.mu,
                                           state.opt_state.nu]))
    np.savez(out_path.replace(".npz", f"{rank}.npz"), **res)
    import torch.distributed as dist
    dist.destroy_process_group()


def _one(store, inputs, out_path):
    """One process: a world of one rank against ``LOCAL``, one device
    accumulating the ranks' pieces, and the one-device pins."""
    _init_ranks(0, 1, store)
    from repro_torch.configs import registry
    from repro_torch.configs.base import (OptimizerConfig, ParallelConfig,
                                          RunConfig, ShapeConfig)
    from repro_torch.launch import steps as STEPS
    from repro_torch.optim import adam as TOPT
    from repro_torch.parallel.context import LOCAL
    from repro_torch.train.trainer import Trainer
    flat = dict(np.load(inputs))
    res = {}
    ctx = _mesh_ctx((1, 1))
    cfg = registry.get_reduced("olmo-1b")
    b = [{k: torch.from_numpy(v) for k, v in x.items()}
         for x in _batches(flat, "olmo-1b", DP_STEPS)]
    for tag, c in (("local", LOCAL), ("mesh", ctx)):
        for scheme in SCHEMES:
            losses, _, wire, p = _dp_run(
                cfg, scheme, _torch_tree(flat, "olmo-1b_p/", cfg), b, c)
            res[f"world1_{tag}_{scheme}"] = np.asarray(
                [_digest(p), json.dumps([losses, wire])])
    for arch, scheme in DP_CASES:
        tag = f"{arch}_{scheme}"
        cfg = registry.get_reduced(arch)
        b = [{k: torch.from_numpy(v) for k, v in x.items()}
             for x in _batches(flat, arch, DP_STEPS)]
        losses, g, _, _ = _dp_run(cfg, scheme, _torch_tree(flat, f"{arch}_p/", cfg),
                                  b, LOCAL, accum_steps=WORLD,
                                  pieces_topk=scheme == "topk")
        res[f"one_{tag}/losses"] = np.asarray(losses)
        res.update({f"one_{tag}/g/{k}": v.numpy() for k, v in
                    _flat(g).items()})
    # the one-device pins: the Trainer with each scheme, and the curves on
    # the shared params against the reference's make_train_step(LOCAL)
    cfg = registry.get_reduced("olmo-1b")
    ocfg = OptimizerConfig(**OPT)
    for scheme in SCHEMES:
        run = RunConfig(model=cfg, shape=ShapeConfig(*PIN_SHAPE),
                        parallel=ParallelConfig(remat="none",
                                                grad_compression=scheme),
                        optimizer=ocfg)
        tr = Trainer(run, device="cpu")
        st = tr.train(2, log_every=1)
        res.update({f"pin_{scheme}/p/{k}": v.numpy() for k, v in
                    _flat(st.params).items()})
        res[f"pin_{scheme}/log"] = np.asarray(json.dumps(tr.metrics_log))
        if scheme == "none":
            continue
        step = STEPS.make_train_step(cfg, run.shape, run.parallel, ocfg)
        p = _torch_tree(flat, "olmo-1b_p/", cfg)
        o, losses = TOPT.init(ocfg, p), []
        for x in _batches(flat, "pin", PIN_STEPS):
            p, o, m = step(p, o, {k: torch.from_numpy(v)
                                  for k, v in x.items()})
            losses.append(float(m["loss"]))
        res[f"pin_{scheme}/losses"] = np.asarray(losses)
    np.savez(out_path, **res)
    import torch.distributed as dist
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# The fixture and the checks (the pytest process)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp_train")
    inputs = tmp / "inputs.npz"
    _make_inputs(inputs)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    me = str(Path(__file__).resolve())

    def start(*args, **extra):
        return subprocess.Popen([sys.executable, *map(str, args)],
                                env=dict(env, **extra),
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
    procs = {"ref": start(me, "reference", inputs, tmp / "ref.npz")}
    for r in range(WORLD):
        procs[f"rank{r}"] = start(me, "rank", r, tmp / "store", inputs,
                                  tmp / "port.npz", tmp)
    for r in range(2):
        procs[f"pair{r}"] = start(me, "pair", r, tmp / "store2",
                                  tmp / "pair.npz", tmp)
    procs["one"] = start(me, "one", tmp / "store1", inputs, tmp / "one.npz")
    cli = ["-m", "repro_torch.launch.train", "--arch", "olmo-1b",
           "--reduced", "--device", "cpu", "--grad-compression", "int8",
           "--steps", CLI_STEPS]
    procs["cli"] = start(*cli)
    for r in range(2):
        procs[f"cli{r}"] = start(
            *cli, "--init-method", f"file://{tmp / 'cli_store'}",
            WORLD_SIZE="2", RANK=str(r), LOCAL_RANK=str(r),
            LOCAL_WORLD_SIZE="2")
    logs = {}
    try:
        for name, p in procs.items():
            logs[name] = p.communicate(timeout=TIMEOUT_S + 60)[0]
    finally:
        for p in procs.values():
            p.kill()
    rcs = {n: p.returncode for n, p in procs.items()}
    assert all(rc == 0 for rc in rcs.values()), (
        rcs, {n: l[-3000:] for n, l in logs.items() if rcs[n]})
    out = {n: dict(np.load(tmp / f"{n}.npz"))
           for n in ("ref", "one")}
    for r in range(WORLD):
        out[f"port{r}"] = dict(np.load(tmp / f"port{r}.npz"))
    for r in range(2):
        out[f"pair{r}"] = dict(np.load(tmp / f"pair{r}.npz"))
    out["inputs"] = dict(np.load(inputs))
    out["logs"] = logs
    out["tmp"] = tmp
    return out


def _loss_bar(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.size
    assert np.all(np.abs(got - want) <= 1e-3 + 2.0 ** -7 * np.abs(want)), (
        got, want)


def _grad_bar(got, want, split_share=0.0):
    """Each leaf within 2^-5 of its largest |g|, on all but
    ``split_share`` of its elements."""
    assert set(got) == set(want) and got
    for k in want:
        tol = GRAD_REL_TOL * np.abs(want[k]).max()
        over = np.abs(got[k] - want[k]) > tol
        assert over.mean() <= split_share, (k, over.mean())


def test_compress_grads_bitwise_the_reference():
    """int8 and topk round trips of trees with a constant-magnitude leaf,
    a leaf under 64 elements, a scalar and a bf16 leaf: bitwise the
    reference's jitted ``compress_grads``, dtypes kept, exactly k kept."""
    import jax
    import jax.numpy as jnp
    from repro.parallel import compression as JCOMP
    from repro_torch.parallel import compression as COMP
    rng = np.random.default_rng(3)
    tree = {"w": (rng.standard_normal((48, 40)) * 5).astype(np.float32),
            "c": np.full((40, 40), 0.5, np.float32),
            "tiny": rng.standard_normal((63,)).astype(np.float32),
            "s": np.float32(3.25),
            "h": rng.standard_normal((16, 16)).astype(np.float32)}
    # a leaf whose largest |g| is one where x / 127 and x * f32(1 / 127)
    # round apart: the reference's jitted scale is the product
    tree["m"] = rng.uniform(-1, 1, (24, 24)).astype(np.float32)
    tree["m"][3, 5] = _split_scale_max()
    for scheme in ("int8", "topk"):
        jt = {k: jnp.asarray(v, _ar_leaf_dtype(k)) for k, v in tree.items()}
        want = jax.jit(lambda t: JCOMP.compress_grads(t, scheme))(jt)
        tt = {k: torch.tensor(v).to(torch.bfloat16 if k == "h"
                                    else torch.float32)
              for k, v in tree.items()}
        got = COMP.compress_grads(tt, scheme)
        for k in tree:
            assert got[k].dtype == tt[k].dtype, k
            assert np.array_equal(got[k].float().numpy(),
                                  np.asarray(want[k].astype(jnp.float32))), (
                scheme, k)
        # sub-MIN_WIRE_SIZE leaves and scalars pass through untouched
        assert got["tiny"] is tt["tiny"] and got["s"] is tt["s"]
    kept = int((COMP.compress_grads({"c": torch.full((40, 40), 0.5)},
                                    "topk")["c"] != 0).sum())
    assert kept == int(40 * 40 * COMP.TOPK_FRAC)
    with pytest.raises(ValueError):
        COMP.compress_grads({"w": torch.ones(64)}, "fp4")
    with pytest.raises(ValueError):
        COMP.wire_bytes({"w": torch.ones(64)}, "fp4")


@pytest.mark.parametrize("scheme", SCHEMES)
def test_wire_bytes_equal_the_reference(scheme):
    """tests/test_quantization.py's accounting cases, and the reference's
    function on the same shapes."""
    import jax.numpy as jnp
    from repro.parallel import compression as JCOMP
    from repro_torch.parallel import compression as COMP
    shapes = {"a": ((256, 128), "float32"), "tiny": ((8,), "float32"),
              "s": ((), "float32"), "h": ((64, 3), "bfloat16")}
    tt = {k: torch.zeros(s, dtype=getattr(torch, d))
          for k, (s, d) in shapes.items()}
    jt = {k: jnp.zeros(s, d) for k, (s, d) in shapes.items()}
    for frac in (COMP.TOPK_FRAC, 0.25):
        assert COMP.wire_bytes(tt, scheme, frac=frac) == \
            JCOMP.wire_bytes(jt, scheme, frac=frac)
    two = {k: tt[k] for k in ("a", "tiny")}
    got = COMP.wire_bytes(two, scheme, frac=0.1)
    if scheme == "none":
        assert got["wire_bytes"] == got["wire_bytes_full"]
    elif scheme == "int8":
        assert got["wire_bytes"] == 256 * 128 + 8 * 4
        assert got["wire_overhead_bytes"] == 4
    else:
        assert got["wire_bytes"] == int(256 * 128 * 0.1) * 8 + 8 * 4


@pytest.mark.parametrize("scheme", ("int8", "topk"))
def test_compress_grads_on_ranks_rows_match_jitted_reference(runs, scheme):
    """The reference's jitted round trip of each rank's exchange tree,
    against the port's: bitwise."""
    from repro_torch.parallel import compression as COMP
    for r in range(WORLD):
        tree = {k: torch.from_numpy(v.copy()).to(
            torch.bfloat16 if k == "h" else torch.float32)
            for k, v in _ar_tree(runs["inputs"], r).items()}
        got = {k: v.float().numpy() for k, v in
               COMP.compress_grads(tree, scheme).items()}
        want = _prefixed(runs["ref"], f"cg_{scheme}_{r}/")
        assert set(got) == set(want)
        for k in want:
            assert np.array_equal(got[k], want[k]), (r, k)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_compressed_allreduce_matches_shard_map(runs, scheme):
    """4 ranks on mesh (4, 1) against the reference's shard_map on 4 host
    devices: int8's wired leaves bitwise, the rest (none, topk, and the
    leaves under 64 elements, summed in f32) within the sums' order; every
    rank gets the same mean; section 7's bars; the wire bytes equal."""
    from repro_torch.parallel import compression as COMP
    got = _prefixed(runs["port0"], f"ar_{scheme}/")
    digests = {str(runs[f"port{r}"][f"ar_{scheme}/digest"])
               for r in range(WORLD)}
    assert len(digests) == 1
    got.pop("digest")
    want = _prefixed(runs["ref"], f"ar_{scheme}/")
    assert set(got) == set(want)
    for k in want:
        if scheme == "int8" and k not in ("tiny", "s"):   # wired leaves
            assert np.array_equal(got[k], want[k]), k
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=AR_RTOL,
                                       atol=AR_ATOL, err_msg=k)
    xs = _prefixed(runs["inputs"], "ar/")
    mean = {k: v.mean(axis=0) for k, v in xs.items()}
    if scheme == "int8":
        for k in ("x", "a", "c", "h", "m"):
            scale = np.abs(xs[k]).max() / 127.0
            assert np.abs(got[k] - mean[k]).max() <= 0.51 * scale, k
    elif scheme == "topk":
        for k in ("x", "a", "c", "h", "m"):
            flat = xs[k].reshape(WORLD, -1)
            kk = int(flat.shape[1] * COMP.TOPK_FRAC)
            sp = np.zeros_like(flat)
            for d in range(WORLD):
                idx = np.argsort(-np.abs(flat[d]), kind="stable")[:kk]
                sp[d, idx] = flat[d, idx]
            np.testing.assert_allclose(
                got[k].reshape(-1), sp.mean(axis=0), rtol=AR_RTOL,
                atol=AR_ATOL, err_msg=k)
    for k in ("tiny", "s"):
        np.testing.assert_allclose(got[k], mean[k], rtol=AR_RTOL,
                                   atol=AR_ATOL)
    wb = _prefixed(runs["ref"], f"wb_{scheme}/")
    tree = {k: torch.zeros(v.shape[1:], dtype=getattr(
        torch, _ar_leaf_dtype(k))) for k, v in xs.items()}
    assert COMP.wire_bytes(tree, scheme) == {k: int(v) for k, v in
                                             wb.items()}


@pytest.mark.parametrize("tag", DP_TAGS)
def test_dp_steps_match_jax_and_one_device(runs, tag):
    """3 Adam steps on mesh (4, 1): losses, the first step's exchanged
    gradient and the wire metrics against the reference's step on 4 host
    devices and against one device accumulating the same 4 pieces; the
    ranks' params bitwise equal after the steps."""
    port, ref, one = runs["port0"], runs["ref"], runs["one"]
    pre = f"dp_{tag}/"
    _loss_bar(port[pre + "losses"], ref[pre + "losses"])
    _loss_bar(port[pre + "losses"], one[f"one_{tag}/losses"])
    g = _prefixed(port, pre + "g/")
    split = TOPK_SPLIT_SHARE if tag.endswith("topk") else 0.0
    _grad_bar(g, _prefixed(ref, pre + "g/"), split)
    _grad_bar(g, _prefixed(one, f"one_{tag}/g/"))
    for k in ("wire_bytes", "wire_bytes_full", "wire_overhead_bytes"):
        assert float(port[pre + k]) == float(ref[pre + k]), k
    assert len({str(runs[f"port{r}"][pre + "digest"])
                for r in range(WORLD)}) == 1


def test_world_of_one_rank_is_local_bitwise(runs):
    one = runs["one"]
    for scheme in SCHEMES:
        assert np.array_equal(one[f"world1_mesh_{scheme}"],
                              one[f"world1_local_{scheme}"]), scheme


def test_decoder_with_a_model_axis_names_its_item(runs):
    msg = str(runs["port0"]["refused"])
    assert "item 12(b)" in msg, msg


def test_trainer_over_ranks_keeps_replicas_and_resumes_bitwise(runs):
    """Reduced olmo-1b with int8 on 2 ranks: the params bitwise equal on
    both ranks after every step; rank 1 alone asks for a preemption at
    step 2, both stop there, and the resume to step 4 is bitwise the
    uninterrupted run (params, m and v)."""
    a, b = runs["pair0"], runs["pair1"]
    assert a["digests"].shape == (TR_STEPS,)
    assert np.array_equal(a["digests"], b["digests"])
    assert len(set(a["digests"])) == TR_STEPS     # the params moved
    _loss_bar(a["losses"], b["losses"])
    assert np.array_equal(a["losses"], b["losses"])
    for r in (a, b):
        assert r["preempted"].tolist() == [1, TR_PREEMPT]
        assert str(r["resumed"]) == str(r["final"])
        assert str(r["resumed_opt"]) == str(r["whole_opt"])


def test_checkpoint_over_ranks_restores_into_one_process_and_jax(runs):
    """Rank 0's checkpoint of the 2-rank run: into a one-process
    ``Trainer`` and into the reference's ``restore``, bitwise."""
    import jax
    from repro.configs import registry as JREG
    from repro.configs.base import OptimizerConfig as JOpt
    from repro.models import api as JAPI
    from repro.optim import adam as JOPT
    from repro.train import checkpoint as JCKPT
    ckpt = str(runs["tmp"] / "tr_whole")
    want_p = _prefixed(runs["pair0"], "p/")
    want_mu = _prefixed(runs["pair0"], "mu/")
    st = _tr_run(ckpt).restore()
    assert st.step == TR_STEPS
    got = {k: v.numpy() for k, v in _flat(st.params).items()}
    assert set(got) == set(want_p)
    for k in want_p:
        assert np.array_equal(got[k], want_p[k]), k
    for k, v in _flat(st.opt_state.mu).items():
        assert np.array_equal(v.numpy(), want_mu[k]), k
    cfg = JREG.get_reduced("olmo-1b")
    shapes = jax.eval_shape(lambda: JAPI.init_params(
        cfg, jax.random.PRNGKey(0)))
    shapes = jax.tree.map(lambda s: jax.ShapeDtypeStruct(s.shape,
                                                         "float32"), shapes)
    like = {"params": shapes,
            "opt": jax.eval_shape(lambda: JOPT.init(JOpt(**OPT), shapes))}
    tree, step, extra = JCKPT.restore(ckpt, like)
    assert step == TR_STEPS and extra["step"] == TR_STEPS
    jp = _flat(jax.tree.map(np.asarray, tree["params"]))
    for k in want_p:
        assert np.array_equal(jp[k], want_p[k]), k


def test_dlrm_trainer_over_the_grid_matches_the_step_loop(runs):
    """Reduced dlrm0's ``Trainer`` on (2, 2), every table row-sharded: its
    3 losses bitwise the step loop's over the same grid; its checkpoint
    (the shards and their m and v gathered) restored onto the grid
    bitwise, on every rank."""
    for r in range(WORLD):
        p = runs[f"port{r}"]
        assert p["dlrm/trainer_losses"].shape == (DLRM_STEPS,)
        assert np.array_equal(p["dlrm/trainer_losses"], p["dlrm/loop_losses"])
        assert int(p["dlrm/restored_step"]) == DLRM_STEPS
        assert str(p["dlrm/restored_digest"]) == str(p["dlrm/state_digest"])
    assert np.array_equal(runs["port0"]["dlrm/trainer_losses"],
                          runs["port3"]["dlrm/trainer_losses"])


def test_one_device_pins(runs):
    """tests/test_quantization.py's Trainer pins on one device: topk moves
    the params off none's; int8's metrics carry the 4x payload cut and
    the scale overhead; none's payload is full width.  The int8 and topk
    curves on shared params within the training bar of the reference's
    ``make_train_step(LOCAL)``."""
    one, ref = runs["one"], runs["ref"]
    none, topk = _prefixed(one, "pin_none/p/"), _prefixed(one, "pin_topk/p/")
    assert max(np.abs(none[k] - topk[k]).max() for k in none) > 1e-6
    m = json.loads(str(one["pin_int8/log"]))[-1]
    assert m["wire_bytes_full"] / m["wire_bytes"] >= 3.9
    assert m["wire_overhead_bytes"] >= 4.0
    m = json.loads(str(one["pin_none/log"]))[-1]
    assert m["wire_bytes"] == m["wire_bytes_full"]
    for scheme in ("int8", "topk"):
        _loss_bar(one[f"pin_{scheme}/losses"], ref[f"pin_{scheme}/losses"])


def test_cli_prints_the_reference_keys_on_one_device_and_rank_0(runs):
    """``launch.train --grad-compression int8`` on one device, then on 2
    ranks through a ``file://`` init method: rank 0 alone prints, the same
    keys, at the same steps."""
    def lines(name):
        return [json.loads(l) for l in runs["logs"][name].splitlines()
                if l.startswith("{")]
    solo, r0, r1 = lines("cli"), lines("cli0"), lines("cli1")
    assert [m["step"] for m in solo] == [m["step"] for m in r0] == \
        list(range(1, CLI_STEPS + 1))
    assert r1 == []
    for m in solo + r0:
        assert set(m) == METRIC_KEYS
        assert m["wire_bytes_full"] / m["wire_bytes"] >= 3.9


if __name__ == "__main__":
    mode = sys.argv[1]
    if mode == "reference":
        _reference(*sys.argv[2:4])
    elif mode == "rank":
        _rank(int(sys.argv[2]), *sys.argv[3:7])
    elif mode == "pair":
        _pair(int(sys.argv[2]), *sys.argv[3:6])
    elif mode == "one":
        _one(*sys.argv[2:5])
    else:
        raise SystemExit(f"unknown mode {mode!r}")
