"""The port's row-sharded embedding path over ranks (``repro_torch``'s
``parallel/context.py``, ``launch/mesh.py``, ``parallel/overlap.py``,
``embeddings/cache.py``, the distributed branch of
``embeddings/engine.py``, ``models/dlrm.py`` and ``launch/steps.py`` under
a ranked context) against the JAX package's on the same mesh shapes.

How it runs.  A module fixture starts, at once:
  * the reference: this file as a script with ``XLA_FLAGS=
    --xla_force_host_platform_device_count=4`` and ``JAX_PLATFORMS=cpu``
    (the pytest process has fixed JAX at one device), on meshes (1, 4) and
    (2, 2) of ("data", "model");
  * the port: 4 ranks, this file as a script once a rank, gloo over a
    ``FileStore`` under ``tmp_path`` (no TCP port: xdist runs several
    workers at once), one torch thread each, meshes (1, 4) and (2, 2);
  * a world of one rank, against ``LOCAL``.
The rank code imports no JAX.  Inputs (tables, ids, the DLRM's params and
batches) come from numpy and torch seeds in this process and go to both
sides as one ``.npz``; each side writes its results as ``.npz``.

Tables: ``tests/spmd_worker.py``'s two (``big`` 4096 x 8 sum, ``big2``
2048 x 8 mean) and a 16-wide third, so there are two width-groups to
pipeline, with the placement thresholds at 0 as the reference's check
sets them (every table row-sharded).

Bars:
  * lookups: rtol 1e-5 / atol 1e-6 against JAX (``spmd_worker.py``'s);
  * lookup gradients: rtol 1e-4 / atol 1e-6 against JAX and against the
    port's one-device gradient;
  * bitwise: pipelined = per-group, cached = uncached (outputs and
    gradients), a world of one rank = ``LOCAL``; the hot-id cache's ids,
    hit rate and rows equal the reference's;
  * ``emb_wire_bf16``: rtol 2^-7, atol 2^-9 of a table's largest |value|
    (the reference combines in bf16 after the wire, the port in f32);
  * drops: at capacity factor 0.25 the same ids read back as zero vectors
    as in the reference (the same outputs within the lookup bar, with
    some rows of them changed by the drops);
  * training (reduced dlrm0, 3 Adam steps at B = 32, f32 params and
    state; the dense tower computes in bf16 in both frameworks, as it
    always does): each loss within 1e-3 + 2^-7 |loss| of JAX's, the
    first step's gradient within 2^-5 of each leaf's largest |g| (the
    DLRM training bars of ``tests/test_torch_train.py``); the final
    params within 2 x the summed learning rates everywhere (Adam moves an
    element by about lr a step, so two runs from one point part by at
    most that) and within 2^-5 of the leaf's largest movement |p_3 - p_0|
    (JAX's) on all but PARAM_SPLIT_SHARE = 1% of its elements: where an
    element's gradient is at the level of bf16 rounding, its Adam
    direction is set by the rounding (2 of top/0/w's 4096 elements,
    0.118 of its movement, at these seeds).
"""
import os
import subprocess
import sys
from datetime import timedelta
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
MESHES = ((1, 4), (2, 2))
TAGS = tuple(f"{d}x{m}" for d, m in MESHES)
WORLD = 4
LOOKUP_SPECS = [("big", 4096, 8, 4.0, 4, "sum"),
                ("big2", 2048, 8, 2.0, 2, "mean"),
                ("wide", 1024, 16, 3.0, 3, "sum")]
B_LOOKUP = 16
B_DROP = 64
DROP_CF = 0.25
CACHE_CAPACITY = 64
B_TRAIN = 32
TRAIN_STEPS = 3
OPT = dict(lr=3e-3, warmup_steps=2)
# (REPLICATE_BYTES, TABLE_SHARD_BYTES): every table row-sharded; tables
# 0-2 (<= 4 KiB) replicated beside 3-5 sharded
TRAIN_CASES = {"sharded": (0, 0), "mixed": (4096, 0)}
LOOKUP_RTOL, LOOKUP_ATOL = 1e-5, 1e-6
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
GRAD_REL_TOL = 2.0 ** -5
PARAM_SPLIT_SHARE = 0.01
TIMEOUT_S = 240


# ---------------------------------------------------------------------------
# Shared by both sides: trees <-> flat npz keys
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


def _unflat(flat, prefix):
    """{"<prefix>tables/group_d8": x, "<prefix>bottom/0/w": y, ...} -> the
    nested tree (digit keys become lists)."""
    root = {}
    for key, v in flat.items():
        if not key.startswith(prefix):
            continue
        parts = key[len(prefix):].split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v

    def fix(n):
        if isinstance(n, dict):
            if n and all(k.isdigit() for k in n):
                return [fix(n[k]) for k in sorted(n, key=int)]
            return {k: fix(v) for k, v in n.items()}
        return n
    return fix(root)


def _batches(flat, case_prefix="batch"):
    return [{k.split("/", 1)[1]: v for k, v in flat.items()
             if k.startswith(f"{case_prefix}{s}/")}
            for s in range(TRAIN_STEPS)]


def _features(flat, key):
    return {n: flat[f"{key}/{n}"] for n, *_ in LOOKUP_SPECS}


class _Thresholds:
    """The placement thresholds of ``module`` set for a block."""

    def __init__(self, module, rep, tab):
        self.m, self.new = module, (rep, tab)

    def __enter__(self):
        self.old = (self.m.REPLICATE_BYTES, self.m.TABLE_SHARD_BYTES)
        self.m.REPLICATE_BYTES, self.m.TABLE_SHARD_BYTES = self.new

    def __exit__(self, *a):
        self.m.REPLICATE_BYTES, self.m.TABLE_SHARD_BYTES = self.old


# ---------------------------------------------------------------------------
# Inputs (this process)
# ---------------------------------------------------------------------------

def _make_inputs(path):
    from repro_torch.configs import registry
    from repro_torch.configs.base import EmbeddingTableConfig, ShapeConfig
    from repro_torch.data.synthetic import Dataset
    from repro_torch.embeddings import engine as TENG
    from repro_torch.embeddings import sharding as TSH
    from repro_torch.models import dlrm as TDL
    rng = np.random.default_rng(0)
    flat = {}
    specs = [EmbeddingTableConfig(*r) for r in LOOKUP_SPECS]
    with _Thresholds(TSH, 0, 0):
        coll = TENG.EmbeddingCollection(specs, 4)
    for dim, g in sorted(coll.groups.items()):
        flat[f"lookup/{g.name}"] = (rng.standard_normal(
            (g.total_rows, dim)) * 0.01).astype(np.float32)
    for key, B in (("feats", B_LOOKUP), ("feats2", B_LOOKUP),
                   ("drop", B_DROP)):
        for t in specs:
            ids = rng.integers(-1, t.vocab_size, size=(B, t.max_valency))
            flat[f"{key}/{t.name}"] = ids.astype(np.int32)
    cfg = registry.get_reduced("dlrm0")
    for case, (rep, tab) in TRAIN_CASES.items():
        with _Thresholds(TSH, rep, tab):
            tcoll = TENG.EmbeddingCollection(cfg.dlrm.tables, 4,
                                             fused_storage=True)
        gen = torch.Generator().manual_seed(1)
        d = cfg.dlrm
        p = {"tables": tcoll.init(gen),
             "bottom": TDL._mlp_init(gen, d.bottom_mlp, d.dense_features,
                                     "cpu"),
             "top": TDL._mlp_init(gen, d.top_mlp, d.bottom_mlp[-1]
                                  + sum(t.dim for t in d.tables), "cpu")}
        for k, v in _flat(p).items():
            flat[f"{case}/{k}"] = v.numpy()
    data = Dataset(cfg, ShapeConfig("t", "train", 1, B_TRAIN))
    for s in range(TRAIN_STEPS):
        for k, v in data.batch(s).items():
            flat[f"batch{s}/{k}"] = v
    np.savez(path, **flat)


# ---------------------------------------------------------------------------
# The reference (a subprocess with 4 host devices)
# ---------------------------------------------------------------------------

def _reference(inputs, out_path):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=4")
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    import jax.numpy as jnp
    import repro.embeddings.sharding as ESH
    from repro.configs import registry
    from repro.configs.base import EmbeddingTableConfig
    from repro.configs.base import OptimizerConfig, ParallelConfig, ShapeConfig
    from repro.embeddings.cache import HotIdCache
    from repro.embeddings.engine import (EmbeddingCollection,
                                         PipelinedEmbeddingExecutor)
    from repro.launch import steps as STEPS
    from repro.launch.mesh import make_mesh, mesh_scope
    from repro.optim import adam as JOPT
    from repro.parallel.context import ParallelContext

    flat = dict(np.load(inputs))
    res = {}
    specs = [EmbeddingTableConfig(*r) for r in LOOKUP_SPECS]
    with _Thresholds(ESH, 0, 0):
        coll = EmbeddingCollection(specs, 4)
    params = {k.split("/", 1)[1]: jnp.asarray(v) for k, v in flat.items()
              if k.startswith("lookup/")}
    feats = {k: jnp.asarray(v) for k, v in _features(flat, "feats").items()}
    drop = {k: jnp.asarray(v) for k, v in _features(flat, "drop").items()}

    def sq(out):
        return sum(jnp.sum(v ** 2) for v in out.values())

    for (dd, mm), tag in zip(MESHES, TAGS):
        mesh = make_mesh((dd, mm), ("data", "model"))
        ctx = ParallelContext(mesh=mesh, data_axis="data",
                              model_axis="model")
        dctx = ParallelContext(mesh=mesh, data_axis="data",
                               model_axis="model",
                               emb_capacity_factor=DROP_CF)
        wctx = ParallelContext(mesh=mesh, data_axis="data",
                               model_axis="model", emb_wire_bf16=True)
        with mesh_scope(mesh):
            for method in ("a2a", "psum"):
                out = jax.jit(lambda p, f: coll.lookup(
                    p, f, wctx, method=method))(params, feats)
                res.update({f"bf16{method}_{tag}/{k}":
                            np.asarray(v, np.float32)
                            for k, v in out.items()})
            for method in ("a2a", "psum"):
                out = jax.jit(lambda p, f: coll.lookup(
                    p, f, ctx, method=method))(params, feats)
                g = jax.jit(jax.grad(lambda p: sq(coll.lookup(
                    p, feats, ctx, method=method))))(params)
                res.update({f"{method}_{tag}/{k}": np.asarray(v)
                            for k, v in out.items()})
                res.update({f"g{method}_{tag}/{k}": np.asarray(v)
                            for k, v in g.items()})
            out = jax.jit(lambda p, f: coll.lookup(
                p, f, dctx, method="a2a"))(params, drop)
            res.update({f"drop_{tag}/{k}": np.asarray(v)
                        for k, v in out.items()})
            out = jax.jit(lambda p, f: coll.lookup(
                p, f, ctx, method="a2a"))(params, drop)
            res.update({f"nodrop_{tag}/{k}": np.asarray(v)
                        for k, v in out.items()})

    # the hot-id cache through the executor's bookkeeping, host side
    ex = PipelinedEmbeddingExecutor(
        coll, cache=HotIdCache(capacity=CACHE_CAPACITY), method="a2a")
    ex.step(params, {k: np.asarray(v) for k, v in feats.items()})
    ex.observe(_features(flat, "feats2"))
    for name, (ids, rows) in ex.cache.arrays().items():
        res[f"cache/{name}/ids"] = np.asarray(ids)
        res[f"cache/{name}/rows"] = np.asarray(rows)
    res["cache/hit_rate"] = np.asarray(ex.cache.hit_rate)

    cfg = registry.get_reduced("dlrm0")
    shape = ShapeConfig("t", "train", 1, B_TRAIN)
    ocfg = OptimizerConfig(**OPT)
    batches = [{k: jnp.asarray(v) for k, v in b.items()}
               for b in _batches(flat)]
    for case, (rep, tab) in TRAIN_CASES.items():
        for (dd, mm), tag in zip(MESHES, TAGS):
            mesh = make_mesh((dd, mm), ("data", "model"))
            ctx = ParallelContext(mesh=mesh, data_axis="data",
                                  model_axis="model")
            p = jax.tree.map(jnp.asarray, _unflat(flat, f"{case}/"))
            with _Thresholds(ESH, rep, tab), mesh_scope(mesh):
                (_, _), g = jax.jit(jax.value_and_grad(
                    lambda q: STEPS.loss_fn(cfg, q, batches[0], ctx),
                    has_aux=True))(p)
                step = jax.jit(STEPS.make_train_step(
                    cfg, shape, ParallelConfig(remat="none"), ocfg, ctx))
                o = JOPT.init(ocfg, p)
                losses = []
                for b in batches:
                    p, o, m = step(p, o, b)
                    losses.append(float(m["loss"]))
            res[f"train_{case}_{tag}/losses"] = np.asarray(losses)
            for k, v in _flat(jax.tree.map(np.asarray, p)).items():
                res[f"train_{case}_{tag}/p/{k}"] = v
            for k, v in _flat(jax.tree.map(np.asarray, g)).items():
                res[f"train_{case}_{tag}/g/{k}"] = v
    np.savez(out_path, **res)


# ---------------------------------------------------------------------------
# The port (4 gloo ranks; no JAX)
# ---------------------------------------------------------------------------

def _init_ranks(rank, world, store):
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=TIMEOUT_S))


def _lookup_sq(out):
    return sum((v ** 2).sum() for v in out.values())


def _whole_grads(params, ctx):
    """A rank's gradient shares of sharded spaces -> the whole gradient:
    summed over the data axis, gathered over the model axis."""
    from repro_torch import interop
    g = {k: ctx.all_reduce(v.grad, ctx.data_axis) for k, v in params.items()}
    return interop.gather_params({"tables": g}, ctx)["tables"]


def _rank(rank, store, inputs, out_path):
    _init_ranks(rank, WORLD, store)
    from repro_torch import interop
    from repro_torch.configs import registry
    from repro_torch.configs.base import (EmbeddingTableConfig,
                                          OptimizerConfig, ParallelConfig,
                                          ShapeConfig)
    from repro_torch.embeddings import sharding as TSH
    from repro_torch.embeddings.cache import HotIdCache
    from repro_torch.embeddings.engine import (EmbeddingCollection,
                                               PipelinedEmbeddingExecutor)
    from repro_torch.launch import steps as STEPS
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import dlrm as TDL
    from repro_torch.optim import adam as TOPT
    from repro_torch.parallel.context import ParallelContext

    flat = dict(np.load(inputs))
    res = {}
    specs = [EmbeddingTableConfig(*r) for r in LOOKUP_SPECS]
    with _Thresholds(TSH, 0, 0):
        coll = EmbeddingCollection(specs, 4)
    whole = {k.split("/", 1)[1]: v for k, v in flat.items()
             if k.startswith("lookup/")}
    gfeats = {k: torch.from_numpy(v) for k, v in
              _features(flat, "feats").items()}
    gdrop = {k: torch.from_numpy(v) for k, v in
             _features(flat, "drop").items()}

    def gathered(o, ctx):
        return {k: ctx.all_gather(v.detach()).numpy() for k, v in o.items()}

    def local(f, ctx):
        rows = ctx.local_rows(next(iter(f.values())).shape[0])
        return {k: v[rows] for k, v in f.items()}

    # the port's one-device lookup and gradient on the whole tables
    tp = {k: torch.from_numpy(v).requires_grad_(True)
          for k, v in whole.items()}
    _lookup_sq(coll.lookup(tp, gfeats)).backward()
    g_one = {k: v.grad.numpy() for k, v in tp.items()}

    for shape, tag in zip(MESHES, TAGS):
        mesh = make_mesh(shape, ("data", "model"),
                         timeout=timedelta(seconds=TIMEOUT_S))
        ctx = ParallelContext(mesh=mesh)
        feats = local(gfeats, ctx)

        def shards():
            t = interop.rank_params({"tables": whole}, ctx)["tables"]
            return {k: v.requires_grad_(True) for k, v in t.items()}

        outs, grads = {}, {}
        for name, method, fused in (("a2a", "a2a", True),
                                    ("pergroup", "a2a", False),
                                    ("psum", "psum", True),
                                    ("psum_pergroup", "psum", False)):
            p = shards()
            o = coll.lookup(p, feats, ctx, method=method, fused=fused)
            _lookup_sq(o).backward()
            outs[name] = gathered(o, ctx)
            grads[name] = {k: v.numpy() for k, v in
                           _whole_grads(p, ctx).items()}
        # the cache, kept by the executor: the step's ids, then a second
        # batch observed against the snapshot
        cache = HotIdCache(capacity=CACHE_CAPACITY)
        ex = PipelinedEmbeddingExecutor(coll, cache=cache, method="a2a")
        p = shards()
        ex.step(p, feats, ctx)
        ex.observe(local({k: torch.from_numpy(v) for k, v in
                          _features(flat, "feats2").items()}, ctx), ctx)
        o = ex.lookup(p, feats, ctx)
        _lookup_sq(o).backward()
        outs["cached"] = gathered(o, ctx)
        grads["cached"] = {k: v.numpy() for k, v in
                           _whole_grads(p, ctx).items()}
        dctx = ParallelContext(mesh=mesh, emb_capacity_factor=DROP_CF)
        wctx = ParallelContext(mesh=mesh, emb_wire_bf16=True)
        ddrop = local(gdrop, ctx)
        with torch.no_grad():
            for method in ("a2a", "psum"):
                outs[f"bf16{method}"] = gathered(coll.lookup(
                    shards(), feats, wctx, method=method), ctx)
            outs["drop"] = gathered(coll.lookup(shards(), ddrop, dctx,
                                                method="a2a"), ctx)
            outs["nodrop"] = gathered(coll.lookup(shards(), ddrop, ctx,
                                                  method="a2a"), ctx)
        for name, o in outs.items():
            res.update({f"{name}_{tag}/{k}": v for k, v in o.items()})
        for name, g in grads.items():
            res.update({f"g{name}_{tag}/{k}": v for k, v in g.items()})
        for name, (ids, rows) in cache.arrays().items():
            res[f"cache_{tag}/{name}/ids"] = ids.numpy()
            res[f"cache_{tag}/{name}/rows"] = rows.numpy()
        res[f"cache_{tag}/hit_rate"] = np.asarray(cache.hit_rate)

    cfg = registry.get_reduced("dlrm0")
    shape = ShapeConfig("t", "train", 1, B_TRAIN)
    ocfg = OptimizerConfig(**OPT)
    pcfg = ParallelConfig(remat="none")
    batches = [{k: torch.from_numpy(v) for k, v in b.items()}
               for b in _batches(flat)]
    for case, (rep, tab) in TRAIN_CASES.items():
        TDL.collection_for.cache_clear()
        with _Thresholds(TSH, rep, tab):
            for shape_, tag in zip(MESHES, TAGS):
                mesh = make_mesh(shape_, ("data", "model"),
                                 timeout=timedelta(seconds=TIMEOUT_S))
                ctx = ParallelContext(mesh=mesh)
                p = interop.rank_params(_unflat(flat, f"{case}/"), ctx)
                mine = [local(b, ctx) for b in batches]
                _, g = STEPS.value_and_grad(cfg, pcfg, p, mine[0], ctx)
                step = STEPS.make_train_step(cfg, shape, pcfg, ocfg, ctx)
                o = TOPT.init(ocfg, p)
                losses = []
                for b in mine:
                    p, o, m = step(p, o, b)
                    losses.append(float(m["loss"]))
                res[f"train_{case}_{tag}/losses"] = np.asarray(losses)
                # gradients come back in leaves order: put them in the tree
                gt = _refill(TOPT.tree_map(lambda x: None, p), iter(g))
                for k, v in _flat(interop.gather_params(gt, ctx)).items():
                    res[f"train_{case}_{tag}/g/{k}"] = v.numpy()
                for k, v in _flat(interop.gather_params(p, ctx)).items():
                    res[f"train_{case}_{tag}/p/{k}"] = v.numpy()
        TDL.collection_for.cache_clear()
    if rank == 0:
        res.update({f"gone/{k}": v for k, v in g_one.items()})
        np.savez(out_path, **res)
    import torch.distributed as dist
    dist.destroy_process_group()


def _refill(tree, it):
    """``tree``'s leaves replaced, in ``OPT.leaves`` order (dict keys
    sorted), by the items of ``it``."""
    if isinstance(tree, dict):
        return {k: _refill(tree[k], it) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_refill(v, it) for v in tree)
    return next(it)


def _one_rank(store, inputs, out_path):
    """A world of one rank, mesh (1, 1): lookups, gradients and three
    train steps against ``LOCAL``, which must be bitwise equal."""
    _init_ranks(0, 1, store)
    from repro_torch.configs import registry
    from repro_torch.configs.base import (EmbeddingTableConfig,
                                          OptimizerConfig, ParallelConfig,
                                          ShapeConfig)
    from repro_torch.embeddings import sharding as TSH
    from repro_torch.embeddings.engine import EmbeddingCollection
    from repro_torch.launch import steps as STEPS
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import dlrm as TDL
    from repro_torch.optim import adam as TOPT
    from repro_torch.parallel.context import LOCAL, ParallelContext

    flat = dict(np.load(inputs))
    ctx = ParallelContext(mesh=make_local_mesh())
    specs = [EmbeddingTableConfig(*r) for r in LOOKUP_SPECS]
    with _Thresholds(TSH, 0, 0):
        coll = EmbeddingCollection(specs, 4)
    feats = {k: torch.from_numpy(v) for k, v in
             _features(flat, "feats").items()}
    res = {}
    for tag, c in (("local", LOCAL), ("mesh", ctx)):
        for method in ("a2a", "psum"):
            p = {k.split("/", 1)[1]: torch.from_numpy(v).requires_grad_(True)
                 for k, v in flat.items() if k.startswith("lookup/")}
            o = coll.lookup(p, feats, c, method=method)
            _lookup_sq(o).backward()
            res.update({f"{tag}/{method}/out/{k}": v.detach().numpy()
                        for k, v in o.items()})
            res.update({f"{tag}/{method}/g/{k}": v.grad.numpy()
                        for k, v in p.items()})
    cfg = registry.get_reduced("dlrm0")
    shape = ShapeConfig("t", "train", 1, B_TRAIN)
    ocfg = OptimizerConfig(**OPT)
    pcfg = ParallelConfig(remat="none")
    for tag, c in (("local", LOCAL), ("mesh", ctx)):
        p = TDL.init_params(cfg, torch.Generator().manual_seed(3), ctx=c)
        step = STEPS.make_train_step(cfg, shape, pcfg, ocfg, c)
        o = TOPT.init(ocfg, p)
        losses = []
        for b in _batches(flat):
            p, o, m = step(p, o, {k: torch.from_numpy(v)
                                  for k, v in b.items()})
            losses.append(float(m["loss"]))
        res[f"{tag}/train/losses"] = np.asarray(losses)
        res.update({f"{tag}/train/p/{k}": v.numpy()
                    for k, v in _flat(p).items()})
    np.savez(out_path, **res)
    import torch.distributed as dist
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# The fixture and the checks (the pytest process)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded")
    inputs = tmp / "inputs.npz"
    _make_inputs(inputs)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    me = str(Path(__file__).resolve())
    procs = [subprocess.Popen(
        [sys.executable, me, "reference", str(inputs), str(tmp / "ref.npz")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)]
    procs += [subprocess.Popen(
        [sys.executable, me, "rank", str(r), str(tmp / "store"),
         str(inputs), str(tmp / "port.npz")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(WORLD)]
    procs.append(subprocess.Popen(
        [sys.executable, me, "one", str(tmp / "store1"), str(inputs),
         str(tmp / "one.npz")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT_S + 60)[0])
    finally:
        for p in procs:
            p.kill()
    rcs = [p.returncode for p in procs]
    assert rcs == [0] * len(procs), (rcs, [l[-3000:] for l in logs])
    out = {n: dict(np.load(tmp / f"{n}.npz"))
           for n in ("ref", "port", "one")}
    out["start"] = dict(np.load(inputs))
    return out


def _prefixed(d, prefix):
    return {k[len(prefix):]: v for k, v in d.items() if k.startswith(prefix)}


def _allclose(got, want, rtol, atol):
    assert set(got) == set(want) and got
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol,
                                   err_msg=k)


def _equal(a, b):
    assert set(a) == set(b) and a
    for k in a:
        assert np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("method", ["a2a", "psum"])
@pytest.mark.parametrize("tag", TAGS)
def test_lookup_matches_jax(runs, tag, method):
    _allclose(_prefixed(runs["port"], f"{method}_{tag}/"),
              _prefixed(runs["ref"], f"{method}_{tag}/"),
              LOOKUP_RTOL, LOOKUP_ATOL)


@pytest.mark.parametrize("method", ["a2a", "psum"])
@pytest.mark.parametrize("tag", TAGS)
def test_lookup_gradients_match_jax_and_one_device(runs, tag, method):
    got = _prefixed(runs["port"], f"g{method}_{tag}/")
    _allclose(got, _prefixed(runs["ref"], f"g{method}_{tag}/"),
              GRAD_RTOL, GRAD_ATOL)
    _allclose(got, _prefixed(runs["port"], "gone/"), GRAD_RTOL, GRAD_ATOL)


@pytest.mark.parametrize("tag", TAGS)
def test_psum_is_close_to_a2a(runs, tag):
    _allclose(_prefixed(runs["port"], f"psum_{tag}/"),
              _prefixed(runs["port"], f"a2a_{tag}/"),
              LOOKUP_RTOL, LOOKUP_ATOL)


@pytest.mark.parametrize("method", ["", "psum_"])
@pytest.mark.parametrize("tag", TAGS)
def test_pipelined_equals_per_group_bitwise(runs, tag, method):
    pipe = "a2a" if not method else "psum"
    per = "pergroup" if not method else "psum_pergroup"
    _equal(_prefixed(runs["port"], f"{pipe}_{tag}/"),
           _prefixed(runs["port"], f"{per}_{tag}/"))
    _equal(_prefixed(runs["port"], f"g{pipe}_{tag}/"),
           _prefixed(runs["port"], f"g{per}_{tag}/"))


@pytest.mark.parametrize("tag", TAGS)
def test_cached_equals_uncached_bitwise(runs, tag):
    _equal(_prefixed(runs["port"], f"cached_{tag}/"),
           _prefixed(runs["port"], f"a2a_{tag}/"))
    _equal(_prefixed(runs["port"], f"gcached_{tag}/"),
           _prefixed(runs["port"], f"ga2a_{tag}/"))


@pytest.mark.parametrize("tag", TAGS)
def test_hot_id_cache_matches_reference(runs, tag):
    """The executor's bookkeeping: the snapshot's ids (ties in the
    reference's order), its rows (each from its owner, summed over the
    model axis) and the hit rate equal the reference's."""
    got = _prefixed(runs["port"], f"cache_{tag}/")
    want = _prefixed(runs["ref"], "cache/")
    _equal(got, want)
    assert 0.0 < float(got["hit_rate"]) < 1.0


@pytest.mark.parametrize("method", ["a2a", "psum"])
@pytest.mark.parametrize("tag", TAGS)
def test_wire_bf16_matches_jax(runs, tag, method):
    """``emb_wire_bf16``: the vectors (a2a) or partial sums (psum) cross
    the wire in bf16.  The reference combines in bf16 after that and
    returns bf16; the port widens the received vectors to f32 before its
    combine.  So they agree to a few bf16 roundings: rtol 2^-7 and atol
    2^-9 of the table's largest |value|."""
    got = _prefixed(runs["port"], f"bf16{method}_{tag}/")
    want = _prefixed(runs["ref"], f"bf16{method}_{tag}/")
    assert set(got) == set(want) and got
    for k in want:
        np.testing.assert_allclose(
            got[k], want[k], rtol=2.0 ** -7,
            atol=2.0 ** -9 * np.abs(want[k]).max(), err_msg=k)
        assert not np.array_equal(got[k], runs["port"][f"{method}_{tag}/{k}"])


@pytest.mark.parametrize("tag", TAGS)
def test_drops_match_jax(runs, tag):
    got = _prefixed(runs["port"], f"drop_{tag}/")
    _allclose(got, _prefixed(runs["ref"], f"drop_{tag}/"),
              LOOKUP_RTOL, LOOKUP_ATOL)
    full = _prefixed(runs["port"], f"nodrop_{tag}/")
    _allclose(full, _prefixed(runs["ref"], f"nodrop_{tag}/"),
              LOOKUP_RTOL, LOOKUP_ATOL)
    # the capacity bites: some samples lost a vector
    changed = sum(int((np.abs(got[k] - full[k]).max(1) > 0).sum())
                  for k in got)
    assert changed > 0


@pytest.mark.parametrize("tag", TAGS)
@pytest.mark.parametrize("case", sorted(TRAIN_CASES))
def test_dlrm_train_steps_match_jax(runs, case, tag):
    got, want = runs["port"], runs["ref"]
    pre = f"train_{case}_{tag}/"
    gl, wl = got[pre + "losses"], want[pre + "losses"]
    assert gl.shape == wl.shape == (TRAIN_STEPS,)
    assert np.all(np.abs(gl - wl) <= 1e-3 + 2.0 ** -7 * np.abs(wl)), (gl, wl)
    gg, wg = _prefixed(got, pre + "g/"), _prefixed(want, pre + "g/")
    assert set(gg) == set(wg)
    for k in wg:
        assert np.abs(gg[k] - wg[k]).max() <= \
            GRAD_REL_TOL * np.abs(wg[k]).max(), k
    gp, wp = _prefixed(got, pre + "p/"), _prefixed(want, pre + "p/")
    assert set(gp) == set(wp)
    lr = [OPT["lr"] * min(1.0, (s + 1) / OPT["warmup_steps"])
          for s in range(TRAIN_STEPS)]
    for k in wp:
        moved = np.abs(wp[k] - runs["start"][f"{case}/{k}"]).max()
        diff = np.abs(gp[k] - wp[k])
        assert moved > 0, k
        assert diff.max() <= 2 * sum(lr), k
        assert (diff > GRAD_REL_TOL * moved).mean() <= PARAM_SPLIT_SHARE, k


def test_one_rank_equals_local_bitwise(runs):
    one = runs["one"]
    _equal(_prefixed(one, "mesh/"), _prefixed(one, "local/"))


if __name__ == "__main__":
    mode = sys.argv[1]
    if mode == "reference":
        _reference(*sys.argv[2:4])
    elif mode == "rank":
        _rank(int(sys.argv[2]), *sys.argv[3:6])
    elif mode == "one":
        _one_rank(*sys.argv[2:5])
    else:
        raise SystemExit(f"unknown mode {mode!r}")
