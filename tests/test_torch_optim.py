"""The reference's other optimizers in the port (``optim/adam.py``: sgd
and adafactor) against the JAX package.

  * one step after another against the reference's ``apply`` on a tree
    with a rank-0, a rank-1, a rank-2 and a stacked rank-4 leaf (an expert
    leaf's layout), with and without an active clip, adafactor with
    weight decay; the state's layout (sgd: ``mu``, ``nu`` None;
    adafactor: ``mu`` None, ``{"v"}`` or factored ``{"vr", "vc"}``);
  * adafactor's walk in blocks (whole matrices: bitwise; rows of a
    matrix: within the bar), in place;
  * sgd's bf16 momentum keeps its dtype;
  * 3-step reduced olmo-1b loss curves of the port's ``Trainer`` against
    the reference's ``Trainer``, one for each optimizer.

Tolerances: params and state within OPT_RTOL = 1e-6 of each element and
of the leaf's largest |x| (the Adam parity bar of
``tests/test_torch_train.py``: the same f32 operations, the global norm
summed in another order); the loss curve within 1e-3 + 2^-7 |loss|.
"""
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
from repro.train.trainer import Trainer as JTrainer
from repro_torch import interop
from repro_torch.configs import registry as TREG
from repro_torch.configs.base import OptimizerConfig as TOpt
from repro_torch.configs.base import ParallelConfig as TPar
from repro_torch.configs.base import RunConfig as TRun
from repro_torch.configs.base import ShapeConfig as TShape
from repro_torch.optim import adam as TOPT
from repro_torch.train.trainer import Trainer, TrainerState

OPT_RTOL = 1e-6


def _opt_tree(rng, scale=1.0):
    """A rank-0, a rank-1, a rank-2 and a stacked rank-4 leaf (an expert
    leaf's layout: layers x experts x in x out), dict keys out of order."""
    def a(*shape):
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    return {"z": a(6, 5), "moe": {"wg": a(2, 3, 6, 4)}, "b": a(7), "s": a()}


OPT_CASES = {            # OptimizerConfig fields, grad scale
    "sgd": (dict(name="sgd", lr=1e-2, warmup_steps=2), 0.5),
    "sgd_clip": (dict(name="sgd", lr=1e-2, warmup_steps=1, grad_clip=0.5),
                 2.0),
    "adafactor": (dict(name="adafactor", lr=1e-2, warmup_steps=2), 0.5),
    "adafactor_clip_decay": (dict(name="adafactor", lr=3e-3, warmup_steps=1,
                                  grad_clip=0.5, weight_decay=0.1), 2.0),
}


def _opt_close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=OPT_RTOL,
                               atol=OPT_RTOL * np.abs(want).max())


@pytest.mark.parametrize("case", list(OPT_CASES))
def test_sgd_and_adafactor_match_reference(case):
    kw, gscale = OPT_CASES[case]
    rng = np.random.default_rng(len(case))
    params = _opt_tree(rng)
    jcfg, tcfg = JOpt(**kw), TOpt(**kw)
    jp = jax.tree.map(jnp.asarray, params)
    jst = JOPT.init(jcfg, jp)
    tp = interop.params_from_numpy(params)
    tst = TOPT.init(tcfg, tp)
    for _ in range(3):
        g = _opt_tree(rng, gscale)
        jp, jst, jm = JOPT.apply(jcfg, jp, jax.tree.map(jnp.asarray, g), jst)
        tp, tst, tm = TOPT.apply(tcfg, tp, interop.params_from_numpy(g), tst)
        for got, want in ((tp, jp), (tst.mu, jst.mu), (tst.nu, jst.nu)):
            assert (got is None) == (want is None)
            if got is None:
                continue
            jl = jax.tree.leaves(want)
            assert len(TOPT.leaves(got)) == len(jl)
            for x, y in zip(TOPT.leaves(got), jl):
                _opt_close(x, y)
        np.testing.assert_allclose(tm["grad_norm"].item(),
                                   float(jm["grad_norm"]), rtol=OPT_RTOL)
        assert tm["lr"].item() == float(jm["lr"])
        assert tst.step == int(jst.step)
    if case.endswith("clip") or "clip_" in case:
        assert tcfg.grad_clip < float(jm["grad_norm"])


@pytest.mark.parametrize("chunk", [30, 7])
def test_adafactor_walks_leaves_in_blocks(monkeypatch, chunk):
    """Blocks of whole matrices (30: one 6x4 or 6x5 matrix a block) give
    the same update bit for bit; blocks of rows (7: one row of a 6x5 or
    6x4 matrix) the same within OPT_RTOL (the column sums add in another
    order).  Params and factors are written where they lie."""
    cfg = TOpt(name="adafactor", lr=1e-2, warmup_steps=1, weight_decay=0.1)
    rng = np.random.default_rng(11)
    params, grads = _opt_tree(rng), _opt_tree(rng)
    ref = interop.params_from_numpy(params)
    ref, rst, _ = TOPT.apply(cfg, ref, interop.params_from_numpy(grads),
                             TOPT.init(cfg, ref))
    monkeypatch.setattr(TOPT, "CHUNK", chunk)
    tp = interop.params_from_numpy(params)
    st = TOPT.init(cfg, tp)
    ptrs = [x.data_ptr() for x in TOPT.leaves(tp) + TOPT.leaves(st.nu)]
    p2, st2, _ = TOPT.apply(cfg, tp, interop.params_from_numpy(grads), st)
    assert [x.data_ptr() for x in TOPT.leaves(p2) + TOPT.leaves(st2.nu)] \
        == ptrs
    for got, want in ((p2, ref), (st2.nu, rst.nu)):
        for x, y in zip(TOPT.leaves(got), TOPT.leaves(want)):
            if chunk == 30:
                assert torch.equal(x, y)
            else:
                _opt_close(x, y.numpy())


def test_sgd_bf16_momentum_keeps_its_dtype():
    cfg = TOpt(name="sgd", state_dtype="bfloat16", warmup_steps=1)
    p = {"w": torch.ones(4, 3)}
    st = TOPT.init(cfg, p)
    p, st, _ = TOPT.apply(cfg, p, {"w": torch.full((4, 3), 0.5)}, st)
    assert st.mu["w"].dtype == torch.bfloat16 and st.nu is None
    assert p["w"].dtype == torch.float32 and (p["w"] < 1).all()


def _loss_close(got, want):
    return abs(got - want) <= 1e-3 + 2.0 ** -7 * abs(want)


@pytest.mark.parametrize("opt", ["sgd", "adafactor"])
def test_reduced_olmo_curve_matches_jax_trainer(opt):
    """3 steps of reduced olmo-1b from the reference Trainer's init: the
    port's Trainer against the reference's."""
    ocfg = dict(name=opt, lr=1e-3, warmup_steps=2)
    jrun = JRun(model=JREG.get_reduced("olmo-1b"),
                shape=JShape("t", "train", 16, 2),
                parallel=JPar(remat="none"), optimizer=JOpt(**ocfg))
    jtr = JTrainer(jrun, make_local_mesh())
    st = jtr.init_state()
    npp = jax.tree.map(lambda a: np.array(a, copy=True), st.params)
    jtr.train(3, state=st, log_every=1)
    want = [m["loss"] for m in jtr.metrics_log]
    run = TRun(model=TREG.get_reduced("olmo-1b"),
               shape=TShape("t", "train", 16, 2),
               parallel=TPar(remat="none"), optimizer=TOpt(**ocfg))
    tr = Trainer(run, device="cpu")
    tp = interop.params_from_numpy(npp)
    st = tr.train(3, state=TrainerState(tp, TOPT.init(run.optimizer, tp),
                                        0), log_every=1)
    got = [m["loss"] for m in tr.metrics_log]
    assert len(got) == len(want) == 3 and st.opt_state.step == 3
    assert all(_loss_close(g, w) for g, w in zip(got, want)), (got, want)
