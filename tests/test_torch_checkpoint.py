"""The port's checkpoints (``repro_torch/train/checkpoint.py``) against the
reference's format v2, in both directions.

  * the checkpoint half of ``tests/test_optim_checkpoint.py`` on the port:
    round trip, latest wins, any ``shards=`` bitwise, the layout on disk,
    ``gc`` keeps the last n and never touches v1, v1 restores;
  * leaf keys are ``jax.tree_util.keystr`` strings (dicts, lists, tuples,
    the optimizer's NamedTuple);
  * a checkpoint the JAX package wrote restores into the port bitwise and
    the port's restores through ``repro.train.checkpoint.restore`` bitwise,
    bf16 leaves included; a JAX ``Trainer``'s checkpoint of reduced
    olmo-1b restores into the port's ``Trainer`` (params, m, v, step) and
    back, bit for bit.

Every comparison here is exact.
"""
import json
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs import registry as JREG
from repro.configs.base import OptimizerConfig as JOpt
from repro.configs.base import ParallelConfig as JPar
from repro.configs.base import RunConfig as JRun
from repro.configs.base import ShapeConfig as JShape
from repro.launch.mesh import make_local_mesh
from repro.optim import adam as JOPT
from repro.train import checkpoint as JCKPT
from repro.train.trainer import Trainer as JTrainer
from repro_torch.configs import registry as TREG
from repro_torch.configs.base import OptimizerConfig as TOpt
from repro_torch.configs.base import ParallelConfig as TPar
from repro_torch.configs.base import RunConfig as TRun
from repro_torch.configs.base import ShapeConfig as TShape
from repro_torch.optim import adam as TOPT
from repro_torch.train import checkpoint as CKPT
from repro_torch.train.trainer import Trainer


def _bits(x) -> np.ndarray:
    """A leaf's values as f32 (bf16 widens exactly) or its own dtype."""
    if isinstance(x, torch.Tensor):
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    arr = np.asarray(x)
    return arr.astype(np.float32) if arr.dtype == jnp.bfloat16 else arr


def _equal(a, b):
    a, b = _bits(a), _bits(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape,
                                                       a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b)


def _like(tree):
    """``tree`` with each tensor as a meta tensor of its shape and dtype."""
    if isinstance(tree, dict):
        return {k: _like(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_like(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_like(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return torch.empty(tree.shape, dtype=tree.dtype, device="meta")
    return tree


def _tree(seed: int):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn((4, 8), generator=g),
            "b": {"c": torch.arange(5, dtype=torch.int32),
                  "d": [torch.ones((2,)),
                        torch.randn((3,), generator=g).to(torch.bfloat16)]},
            "e": {}, "n": None,
            "t": (torch.randn((7, 2), generator=g), torch.tensor(seed))}


# -- the reference's checkpoint tests, on the port --------------------------

def test_roundtrip_exact(tmp_path):
    tree = _tree(0)
    CKPT.save(str(tmp_path), 7, tree)
    assert CKPT.latest_step(str(tmp_path)) == 7
    got, step, extra = CKPT.restore(str(tmp_path), _like(tree))
    assert step == 7 and extra == {}
    for (ka, a), (kb, b) in zip(CKPT.flatten(tree), CKPT.flatten(got)):
        assert ka == kb and b.device.type == "cpu"
        _equal(a, b)
    assert got["e"] == {} and got["n"] is None
    assert isinstance(got["t"], tuple)


def test_multiple_steps_latest_wins(tmp_path):
    tree = {"w": torch.ones(3)}
    CKPT.save(str(tmp_path), 1, tree)
    CKPT.save(str(tmp_path), 2, {"w": tree["w"] * 2})
    got, step, _ = CKPT.restore(str(tmp_path), _like(tree))
    assert step == 2 and torch.equal(got["w"], torch.full((3,), 2.0))
    got, step, _ = CKPT.restore(str(tmp_path), _like(tree), step=1)
    assert step == 1 and torch.equal(got["w"], torch.ones(3))


@pytest.mark.parametrize("shards", [1, 2, 3, 4])
@pytest.mark.parametrize("seed", [0, 9])
def test_roundtrip_bitwise_any_shards(tmp_path, seed, shards):
    """f32 / bf16 / int32 leaves, 0-d through 3-d, odd leading dims, a
    host-int leaf: bitwise at any shard split."""
    g = torch.Generator().manual_seed(seed)
    tree = {"w": torch.randn((5, 3), generator=g),
            "b16": torch.randn((7,), generator=g).to(torch.bfloat16),
            "cube": torch.randn((3, 2, 5), generator=g),
            "n": {"ids": torch.arange(seed % 9 + 1, dtype=torch.int32),
                  "step": torch.tensor(seed, dtype=torch.int32)},
            "host_step": seed}
    CKPT.save(str(tmp_path), 3, tree, shards=shards)
    like = dict(_like({k: v for k, v in tree.items() if k != "host_step"}),
                host_step=0)
    got, step, _ = CKPT.restore(str(tmp_path), like)
    assert step == 3 and got["host_step"] == seed
    for (_, a), (_, b) in zip(CKPT.flatten(tree), CKPT.flatten(got)):
        if isinstance(a, int):
            continue
        assert a.dtype == b.dtype
        _equal(a, b)


def test_multi_shard_layout_on_disk(tmp_path):
    tree = {"w": torch.randn(10, 4), "tiny": torch.ones(1)}
    CKPT.save(str(tmp_path), 0, tree, shards=3)
    step_dir = tmp_path / "step_00000000"
    assert sorted(p.name for p in step_dir.glob("shard_*.npz")) == [
        "shard_000.npz", "shard_001.npz", "shard_002.npz"]
    man = CKPT.read_manifest(str(tmp_path))
    assert man["format"] == 2 and man["step"] == 0
    spans = man["leaves"]["['w']"]["spans"]
    assert len(spans) == 3
    assert spans[0]["start"] == [0, 0] and spans[-1]["stop"] == [10, 4]
    assert man["leaves"]["['w']"]["dtype"] == "float32"
    # a 1-row leaf cannot split: a single span in the first file
    assert len(man["leaves"]["['tiny']"]["spans"]) == 1
    got, _, _ = CKPT.restore(str(tmp_path), _like(tree))
    assert torch.equal(got["w"], tree["w"])


def test_gc_keeps_last_n_and_latest(tmp_path):
    tree = {"w": torch.ones(3)}
    for step in (1, 2, 3, 4):
        CKPT.save(str(tmp_path), step, {"w": tree["w"] * step}, keep=2)
    assert sorted(p.name for p in tmp_path.glob("step_*")) == [
        "step_00000003", "step_00000004"]
    got, step, _ = CKPT.restore(str(tmp_path), _like(tree))
    assert step == 4 and torch.equal(got["w"], torch.full((3,), 4.0))
    CKPT.gc(str(tmp_path), 1)
    assert sorted(p.name for p in tmp_path.glob("step_*")) == [
        "step_00000004"]


def _write_v1(root: pathlib.Path, step: int, w: np.ndarray, latest=False):
    d = root / f"step_{step:08d}"
    d.mkdir(parents=True)
    np.savez(d / "arrays.npz", **{"['w']": w})
    (d / "manifest.json").write_text(json.dumps(
        {"step": step, "extra": {"step": step},
         "leaves": {"['w']": {"shape": list(w.shape),
                              "dtype": "float32"}}}))
    if latest:
        (root / "LATEST").write_text(str(step))


def test_gc_never_touches_v1_checkpoints(tmp_path):
    w = np.random.default_rng(0).standard_normal((4, 4)).astype(np.float32)
    _write_v1(tmp_path, 1, w)
    torn = tmp_path / "step_00000002"           # no manifest: off-limits
    torn.mkdir()
    (torn / "shard_000.npz").write_bytes(b"")
    for step in (3, 4, 5, 6):
        CKPT.save(str(tmp_path), step, {"w": torch.from_numpy(w)}, keep=1)
    assert sorted(p.name for p in tmp_path.glob("step_*")) == [
        "step_00000001", "step_00000002", "step_00000006"]
    got, step, _ = CKPT.restore(str(tmp_path), _like({"w": torch.zeros(4, 4)}),
                                step=1)
    assert step == 1 and np.array_equal(got["w"].numpy(), w)


def test_v1_checkpoint_still_restores(tmp_path):
    w = np.random.default_rng(1).standard_normal((4, 4)).astype(np.float32)
    _write_v1(tmp_path, 5, w, latest=True)
    got, step, extra = CKPT.restore(str(tmp_path),
                                    _like({"w": torch.zeros(4, 4)}))
    assert step == 5 and extra == {"step": 5}
    assert np.array_equal(got["w"].numpy(), w)


# -- the reference's keys and files, both ways ------------------------------

def _jax_tree(seed: int):
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    return {"params": {"w": jax.random.normal(k1, (6, 3)),
                       "b16": jax.random.normal(k2, (5,)).astype(
                           jnp.bfloat16),
                       "l": [jnp.arange(4, dtype=jnp.int32),
                             (jnp.ones((2, 2)),)],
                       "empty": {}},
            "opt": JOPT.OptState(jnp.asarray(3, jnp.int32),
                                 {"w": jnp.full((6, 3), 0.5)},
                                 {"w": jnp.full((6, 3), 0.25)})}


def _to_torch(tree):
    if isinstance(tree, JOPT.OptState):
        return TOPT.OptState(int(tree.step), _to_torch(tree.mu),
                             _to_torch(tree.nu))
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_torch(v) for v in tree)
    a = np.asarray(tree)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a.copy())


def test_leaf_keys_are_jax_keystr():
    jt = _jax_tree(0)
    want = [jax.tree_util.keystr(p)
            for p, _ in jax.tree_util.tree_flatten_with_path(jt)[0]]
    assert [k for k, _ in CKPT.flatten(_to_torch(jt))] == want
    assert "['opt'].step" in want and "['opt'].mu['w']" in want


@pytest.mark.parametrize("shards", [1, 3])
def test_jax_checkpoint_restores_into_the_port_bitwise(tmp_path, shards):
    jt = _jax_tree(1)
    JCKPT.save(str(tmp_path), 4, jt, extra={"data_seed": 0}, shards=shards)
    like = _to_torch(jt)
    got, step, extra = CKPT.restore(str(tmp_path), _like(like))
    assert step == 4 and extra == {"data_seed": 0}
    assert got["opt"].step == 3 and isinstance(got["opt"], TOPT.OptState)
    assert got["params"]["b16"].dtype == torch.bfloat16
    flat_j = jax.tree_util.tree_flatten_with_path(jt)[0]
    flat_t = [kv for kv in CKPT.flatten(got)]
    assert len(flat_j) == len(flat_t)
    for (p, a), (k, b) in zip(flat_j, flat_t):
        assert jax.tree_util.keystr(p) == k
        if isinstance(b, int):
            assert b == int(a)
        else:
            _equal(a, b)


@pytest.mark.parametrize("shards", [1, 3])
def test_port_checkpoint_restores_through_jax_bitwise(tmp_path, shards):
    jt = _jax_tree(2)
    CKPT.save(str(tmp_path), 9, _to_torch(jt), extra={"k": [1, 2]},
              shards=shards)
    like = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), jt)
    got, step, extra = JCKPT.restore(str(tmp_path), like)
    assert step == 9 and extra == {"k": [1, 2]}
    for a, b in zip(jax.tree.leaves(jt), jax.tree.leaves(got)):
        assert a.dtype == b.dtype
        _equal(a, b)


# -- Trainer checkpoints, JAX <-> port ----------------------------------------

OCFG = dict(lr=1e-3, warmup_steps=2)


@pytest.fixture(scope="module")
def jax_trained(tmp_path_factory):
    """A JAX Trainer's reduced olmo-1b after 3 steps, checkpointed."""
    d = tmp_path_factory.mktemp("jax_ckpt")
    run = JRun(model=JREG.get_reduced("olmo-1b"),
               shape=JShape("t", "train", 16, 2),
               parallel=JPar(remat="none"), optimizer=JOpt(**OCFG))
    tr = JTrainer(run, make_local_mesh(), ckpt_dir=str(d), ckpt_every=100)
    state = tr.train(3, log_every=1)
    return str(d), state


def _port_run():
    return TRun(model=TREG.get_reduced("olmo-1b"),
                shape=TShape("t", "train", 16, 2),
                parallel=TPar(remat="none"), optimizer=TOpt(**OCFG))


def test_jax_trainer_checkpoint_restores_into_port_trainer(jax_trained):
    d, jstate = jax_trained
    tr = Trainer(_port_run(), device="cpu", ckpt_dir=d)
    state = tr.restore()
    assert state.step == 3 and state.opt_state.step == 3
    jp = jax.tree.leaves(jstate.params)
    tp = TOPT.leaves(state.params)
    assert len(jp) == len(tp) > 0
    for a, b in zip(jp, tp):
        assert b.dtype == torch.float32
        _equal(a, b)
    for name in ("mu", "nu"):
        for a, b in zip(jax.tree.leaves(getattr(jstate.opt_state, name)),
                        TOPT.leaves(getattr(state.opt_state, name))):
            _equal(a, b)


def test_port_trainer_checkpoint_restores_into_jax(jax_trained, tmp_path):
    d, jstate = jax_trained
    # the port continues the JAX run one step and checkpoints at the end
    tr = Trainer(_port_run(), device="cpu", ckpt_dir=str(tmp_path))
    tr.train(4, state=Trainer(_port_run(), device="cpu",
                              ckpt_dir=d).restore())
    assert CKPT.latest_step(str(tmp_path)) == 4
    like = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                        {"params": jstate.params, "opt": jstate.opt_state})
    got, step, extra = JCKPT.restore(str(tmp_path), like)
    assert step == 4 and extra["data_seed"] == 0
    assert int(got["opt"].step) == 4
    mine = tr.restore()
    for a, b in zip(jax.tree.leaves(got["params"]),
                    TOPT.leaves(mine.params)):
        _equal(a, b)
    for a, b in zip(jax.tree.leaves(got["opt"].mu),
                    TOPT.leaves(mine.opt_state.mu)):
        _equal(a, b)


def test_restore_refuses_another_data_seed(jax_trained):
    d, _ = jax_trained
    tr = Trainer(_port_run().replace(seed=1), device="cpu", ckpt_dir=d)
    with pytest.raises(AssertionError, match="data seed"):
        tr.restore()
