"""The port's DLRM training path against the JAX package at reduced size:
the run-level configs, ``data/synthetic.Dataset`` (bitwise), Adam
(``optim/adam.py``), the first step's gradients and a 5-step loss curve
through ``launch/steps.make_train_step`` and ``train/trainer.Trainer``,
the ``repro_torch.launch.train`` CLI, and the paths that are not ported
yet (each raises ``NotImplementedError`` naming its ROADMAP.md item).

Inputs come from numpy seeds; JAX params come over through
``repro_torch.interop``.  Tolerances:
  * Adam: both update in f32 with the same operations in the same order,
    but sum the global norm in other orders: ADAM_RTOL = 1e-6 relative on
    params, m and v, of each element and of the leaf's largest |x|.
  * gradients: the dense tower computes in bf16 in both frameworks with
    other matmul kernels, so each leaf's gradient agrees within
    GRAD_REL_TOL = 2^-5 of its largest |g| (the logits bar of ROADMAP.md);
  * the loss curve: within 1e-3 + 2^-7 |loss| at every step.
"""
import dataclasses

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
from repro.data.synthetic import Dataset as JDataset
from repro.launch import steps as JSTEPS
from repro.models import api as JAPI
from repro.optim import adam as JOPT
from repro.parallel.context import LOCAL
from repro_torch import interop
from repro_torch.configs import registry as TREG
from repro_torch.configs.base import OptimizerConfig as TOpt
from repro_torch.configs.base import ParallelConfig as TPar
from repro_torch.configs.base import RunConfig as TRun
from repro_torch.configs.base import ShapeConfig as TShape
from repro_torch.data.synthetic import Dataset as TDataset
from repro_torch.launch import steps as TSTEPS
from repro_torch.launch import train as TCLI
from repro_torch.models import api as TAPI
from repro_torch.models import dlrm as TDL
from repro_torch.optim import adam as TOPT
from repro_torch.train.trainer import Trainer, TrainerState

ADAM_RTOL = 1e-6
GRAD_REL_TOL = 2.0 ** -5


@pytest.mark.parametrize("name", ["ParallelConfig", "OptimizerConfig",
                                  "RunConfig"])
def test_run_configs_copy_the_reference(name):
    j = {"ParallelConfig": JPar, "OptimizerConfig": JOpt,
         "RunConfig": JRun}[name]
    t = {"ParallelConfig": TPar, "OptimizerConfig": TOpt,
         "RunConfig": TRun}[name]

    def fields(cls):
        return [(f.name, f.default, f.default_factory is not
                 dataclasses.MISSING) for f in dataclasses.fields(cls)]

    assert fields(t) == fields(j)


# -- data ---------------------------------------------------------------------

@pytest.mark.parametrize("arch,kind,seq,B", [("dlrm0", "train", 1, 32),
                                             ("olmo-1b", "train", 16, 4),
                                             ("olmo-1b", "prefill", 9, 3)])
@pytest.mark.parametrize("seed", [0, 5])
def test_dataset_batch_is_bitwise_the_reference(arch, kind, seq, B, seed):
    jd = JDataset(JREG.get_reduced(arch), JShape("d", kind, seq, B),
                  seed=seed)
    td = TDataset(TREG.get_reduced(arch), TShape("d", kind, seq, B),
                  seed=seed)
    for step in (0, 3, 1000):
        want, got = jd.batch(step), td.batch(step)
        assert list(got) == list(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


def test_dataset_audio_branch_names_its_item():
    cfg = TREG.get_reduced("olmo-1b").replace(family="audio")
    with pytest.raises(NotImplementedError, match="item 11"):
        TDataset(cfg, TShape("d", "train", 8, 2)).batch(0)


# -- Adam -------------------------------------------------------------------

def _tree(rng, scale=1.0):
    """A param-like tree: dict keys out of order, a list of layers, a
    scalar leaf."""
    def a(*shape):
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    return {"z": a(5, 7), "layers": [{"w": a(3, 4), "b": a(4)},
                                     {"w": a(4, 2), "b": a(2)}],
            "a": a(9), "s": a()}


ADAM_CASES = {          # OptimizerConfig fields, grad scale
    "clip_inactive": (dict(lr=1e-2, warmup_steps=1, grad_clip=100.0), 0.1),
    "clip_active": (dict(lr=1e-2, warmup_steps=1, grad_clip=0.5), 1.0),
    "warmup": (dict(lr=3e-3, warmup_steps=10), 0.3),
    "weight_decay": (dict(lr=1e-2, warmup_steps=2, weight_decay=0.1), 1.0),
    "adamw_betas": (dict(name="adamw", lr=1e-3, b1=0.8, b2=0.99,
                         eps=1e-6, weight_decay=0.05, warmup_steps=3), 2.0),
}


def _adam_close(got, want):
    """Within ADAM_RTOL of each element and of the leaf's largest |x|:
    the two norms sum in other orders, so the clip factor, and with it
    every g, may differ in the last bit, and m = b1 m + (1 - b1) g can
    cancel to far below the leaf's scale."""
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=ADAM_RTOL,
                               atol=ADAM_RTOL * np.abs(want).max())


@pytest.mark.parametrize("case", list(ADAM_CASES))
def test_adam_matches_reference(case):
    kw, gscale = ADAM_CASES[case]
    rng = np.random.default_rng(len(case))
    params = _tree(rng)
    jcfg, tcfg = JOpt(**kw, state_dtype="float32"), \
        TOpt(**kw, state_dtype="float32")
    jp = jax.tree.map(jnp.asarray, params)
    jst = JOPT.init(jcfg, jp)
    tp = interop.params_from_numpy(params)
    tst = TOPT.init(tcfg, tp)
    for _ in range(3):
        g = _tree(rng, gscale)
        jp, jst, jm = JOPT.apply(jcfg, jp, jax.tree.map(jnp.asarray, g), jst)
        tp, tst, tm = TOPT.apply(tcfg, tp, interop.params_from_numpy(g), tst)
        for got, want in ((tp, jp), (tst.mu, jst.mu), (tst.nu, jst.nu)):
            for x, y in zip(TOPT.leaves(got), jax.tree.leaves(want)):
                _adam_close(x, y)
        np.testing.assert_allclose(tm["grad_norm"].item(),
                                   float(jm["grad_norm"]), rtol=ADAM_RTOL)
        assert tm["lr"].item() == float(jm["lr"])
        assert tst.step == int(jst.step)
    clipped = tcfg.grad_clip < float(jm["grad_norm"])
    if case.startswith("clip_"):
        assert clipped == (case == "clip_active")


def test_clip_and_norm_match_reference():
    rng = np.random.default_rng(3)
    g = _tree(rng, 2.0)
    want, wn = JOPT.clip_by_global_norm(jax.tree.map(jnp.asarray, g), 1.5)
    got, tn = TOPT.clip_by_global_norm(interop.params_from_numpy(g), 1.5)
    np.testing.assert_allclose(tn.item(), float(wn), rtol=ADAM_RTOL)
    for x, y in zip(TOPT.leaves(got), jax.tree.leaves(want)):
        _adam_close(x, y)


def test_adam_updates_in_place_in_blocks(monkeypatch):
    """Blocks smaller than a leaf give the same update, and the params,
    moments and grads are written where they lie."""
    monkeypatch.setattr(TOPT, "CHUNK", 7)
    rng = np.random.default_rng(4)
    cfg = TOpt(lr=1e-2, warmup_steps=1, grad_clip=0.5)
    params, grads = _tree(rng), _tree(rng)
    tp = interop.params_from_numpy(params)
    tg = interop.params_from_numpy(grads)
    st = TOPT.init(cfg, tp)
    ptrs = [x.data_ptr() for x in TOPT.leaves(tp)]
    p2, st2, _ = TOPT.apply(cfg, tp, tg, st)
    assert [x.data_ptr() for x in TOPT.leaves(p2)] == ptrs
    assert st2.mu is st.mu and st2.step == 1
    monkeypatch.setattr(TOPT, "CHUNK", 1 << 26)
    ref = interop.params_from_numpy(params)
    ref, _, _ = TOPT.apply(cfg, ref, interop.params_from_numpy(grads),
                           TOPT.init(cfg, ref))
    for x, y in zip(TOPT.leaves(p2), TOPT.leaves(ref)):
        assert torch.equal(x, y)


def test_adam_bf16_state_keeps_its_dtype():
    cfg = TOpt(state_dtype="bfloat16", warmup_steps=1)
    p = {"w": torch.ones(4, 3)}
    st = TOPT.init(cfg, p)
    p, st, _ = TOPT.apply(cfg, p, {"w": torch.full((4, 3), 0.5)}, st)
    assert st.mu["w"].dtype == torch.bfloat16 and p["w"].dtype == torch.float32
    assert (p["w"] < 1).all()


@pytest.mark.parametrize("name", ["sgd", "adafactor"])
def test_unported_optimizers_name_their_item(name):
    cfg = TOpt(name=name)
    with pytest.raises(NotImplementedError, match="item 7"):
        TOPT.init(cfg, {"w": torch.zeros(2)})
    with pytest.raises(NotImplementedError, match="item 7"):
        TOPT.apply(cfg, {"w": torch.zeros(2)}, {"w": torch.zeros(2)},
                   TOPT.OptState(0, None, None))


# -- the train step ------------------------------------------------------------

@pytest.fixture(scope="module")
def dlrm():
    jcfg, tcfg = JREG.get_reduced("dlrm0"), TREG.get_reduced("dlrm0")
    jp = JAPI.init_params(jcfg, jax.random.PRNGKey(0))
    npp = jax.tree.map(np.asarray, jp)
    return dict(jcfg=jcfg, tcfg=tcfg, jp=jp, npp=npp, B=64)


def _batch(cfg, B, step, jax_side):
    d = (JDataset(cfg, JShape("t", "train", 1, B)) if jax_side
         else TDataset(cfg, TShape("t", "train", 1, B)))
    return d.batch(step)


def test_first_step_gradients_match_jax(dlrm):
    jcfg, tcfg, B = dlrm["jcfg"], dlrm["tcfg"], dlrm["B"]
    nb = _batch(jcfg, B, 0, True)
    (jloss, _), jg = jax.value_and_grad(
        lambda p: JSTEPS.loss_fn(jcfg, p, nb, LOCAL), has_aux=True)(
            dlrm["jp"])
    tp = interop.params_from_numpy(dlrm["npp"])
    metrics, tg = TSTEPS.value_and_grad(
        tcfg, TPar(remat="none"), tp,
        {k: torch.from_numpy(v) for k, v in nb.items()})
    assert abs(metrics["loss"].item() - float(jloss)) <= \
        1e-3 + 2.0 ** -7 * abs(float(jloss))
    jl = jax.tree.leaves(jg)
    assert len(tg) == len(jl)
    for got, want in zip(tg, jl):
        want = np.asarray(want)
        assert got.shape == want.shape and got.dtype == torch.float32
        tol = GRAD_REL_TOL * np.abs(want).max()
        assert np.abs(got.numpy() - want).max() <= tol
    # the tables' gradient is dense, non-zero only on rows the batch names
    gtab = tg[2 * len(tp["bottom"])]          # bottom, tables, top
    assert gtab.shape == tp["tables"]["local_d8"].shape
    named = set()
    for s in TDL.collection_for(tcfg).local_groups[8].slots:
        ids = nb[f"cat_{s.spec.name}"]
        named |= set((ids[ids >= 0] + s.offset).tolist())
    touched = set(torch.nonzero(gtab.abs().sum(1)).reshape(-1).tolist())
    assert touched <= named and len(touched) > len(named) // 2


@pytest.mark.parametrize("accum", [1, 2])
def test_loss_curve_matches_jax_train_step(dlrm, accum):
    """5 steps (2 with accumulation) from the same params and Dataset
    batches: Trainer.train against the reference's jitted train step."""
    jcfg, tcfg, B = dlrm["jcfg"], dlrm["tcfg"], dlrm["B"]
    steps = 5 if accum == 1 else 2
    ocfg = dict(lr=3e-3, warmup_steps=2)
    jstep = jax.jit(JSTEPS.make_train_step(
        jcfg, JShape("t", "train", 1, B), JPar(remat="none"), JOpt(**ocfg),
        LOCAL, accum_steps=accum))
    jp, jo = dlrm["jp"], JOPT.init(JOpt(**ocfg), dlrm["jp"])
    want = []
    for s in range(steps):
        jp, jo, m = jstep(jp, jo, _batch(jcfg, B, s, True))
        want.append(float(m["loss"]))
    run = TRun(model=tcfg, shape=TShape("t", "train", 1, B),
               parallel=TPar(remat="none"), optimizer=TOpt(**ocfg))
    tr = Trainer(run, device="cpu", accum_steps=accum)
    tp = interop.params_from_numpy(dlrm["npp"])
    state = tr.train(steps, state=TrainerState(
        tp, TOPT.init(run.optimizer, tp), 0), log_every=1)
    got = [m["loss"] for m in tr.metrics_log]
    assert [m["step"] for m in tr.metrics_log] == list(range(1, steps + 1))
    for g, w in zip(got, want):
        assert abs(g - w) <= 1e-3 + 2.0 ** -7 * abs(w), (got, want)
    assert state.step == steps and state.opt_state.step == steps
    m = tr.metrics_log[-1]
    assert set(m) == {"loss", "wire_bytes", "wire_bytes_full",
                      "wire_overhead_bytes", "grad_norm", "lr", "step",
                      "wall_s"}
    n_bytes = sum(x.size * 4 for x in jax.tree.leaves(dlrm["npp"]))
    assert m["wire_bytes"] == m["wire_bytes_full"] == n_bytes
    assert m["wire_overhead_bytes"] == 0


def test_pick_accum_steps_matches_reference():
    for arch, shape in (("dlrm0", ("t", "train", 1, 64)),
                        ("olmo-1b", ("t", "train", 64, 8)),
                        ("olmo-1b", ("t", "train", 4096, 64))):
        for chunk in (0, 256):
            want = JSTEPS.pick_accum_steps(JREG.get_reduced(arch),
                                           JShape(*shape), LOCAL,
                                           xent_chunk=chunk,
                                           logits_budget=1 << 20)
            got = TSTEPS.pick_accum_steps(TREG.get_reduced(arch),
                                          TShape(*shape), xent_chunk=chunk,
                                          logits_budget=1 << 20)
            assert got == want


def test_trainer_init_state_and_default_run(dlrm):
    run = TRun(model=dlrm["tcfg"], shape=TShape("t", "train", 1, 16),
               optimizer=TOpt(warmup_steps=1))
    tr = Trainer(run, device="cpu")
    st = tr.init_state()
    before = st.params["tables"]["local_d8"].clone()
    seen = []
    st = tr.train(3, state=st, log_every=2,
                  on_step=lambda s, dt: seen.append(s))
    assert seen == [1, 2, 3] and [m["step"] for m in tr.metrics_log] == [2, 3]
    assert not torch.equal(before, st.params["tables"]["local_d8"])
    assert all(np.isfinite(m["loss"]) for m in tr.metrics_log)


def test_cli_trains_reduced_dlrm0_on_cpu(capsys):
    log = TCLI.main(["--arch", "dlrm0", "--reduced", "--device", "cpu",
                     "--steps", "4", "--batch", "16", "--lr", "1e-3"])
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln]
    assert len(lines) == len(log) == 4
    import json
    rows = [json.loads(ln) for ln in lines]
    assert [r["step"] for r in rows] == [1, 2, 3, 4]
    assert all(np.isfinite(r["loss"]) and r["lr"] > 0 for r in rows)


def _dlrm_run(dlrm):
    return TRun(model=dlrm["tcfg"], shape=TShape("t", "train", 1, 16),
                parallel=TPar(remat="none"),
                optimizer=TOpt(lr=3e-3, warmup_steps=1))


def _same_state(a: TrainerState, b: TrainerState):
    assert a.step == b.step and a.opt_state.step == b.opt_state.step
    for x, y in zip(TOPT.leaves((a.params, a.opt_state.mu, a.opt_state.nu)),
                    TOPT.leaves((b.params, b.opt_state.mu, b.opt_state.nu))):
        assert x.dtype == y.dtype and x.device == y.device
        assert torch.equal(x, y)


def test_dlrm_trainer_checkpoint_restores_bitwise(dlrm, tmp_path):
    """3 steps into a checkpoint; a fresh Trainer restores it (through the
    meta shapes of ``api.param_shapes``) with every leaf and the step
    bitwise the trained state's, and goes on from there."""
    run = _dlrm_run(dlrm)
    tr = Trainer(run, device="cpu", ckpt_dir=str(tmp_path), ckpt_every=2)
    st = tr.train(3, log_every=1)
    got = Trainer(run, device="cpu", ckpt_dir=str(tmp_path)).restore()
    _same_state(got, st)
    meta = TOPT.leaves(TAPI.param_shapes(dlrm["tcfg"]))
    assert [(x.device.type, x.shape, x.dtype) for x in meta] == \
        [("meta", x.shape, x.dtype) for x in TOPT.leaves(st.params)]
    again = Trainer(run, device="cpu", ckpt_dir=str(tmp_path))
    assert again.train(4, log_every=1).step == 4
    assert [m["step"] for m in again.metrics_log] == [4]


def test_dlrm_preempt_and_resume_is_bitwise(dlrm, tmp_path):
    """Preempted at step 2 (checkpointed), resumed by a fresh Trainer: the
    loss curve and the final state are bitwise the uninterrupted run's."""
    run = _dlrm_run(dlrm)
    clean = Trainer(run, device="cpu")
    cstate = clean.train(5, log_every=1)
    first = Trainer(run, device="cpu", ckpt_dir=str(tmp_path),
                    ckpt_every=100)
    st = first.train(5, preempt_at=2, log_every=1)
    assert first.preempted and st.step == 2
    second = Trainer(run, device="cpu", ckpt_dir=str(tmp_path),
                     ckpt_every=100)
    rstate = second.train(5, log_every=1)
    got = [m["loss"] for m in first.metrics_log + second.metrics_log
           if "loss" in m]
    assert got == [m["loss"] for m in clean.metrics_log]
    _same_state(rstate, cstate)


# -- what is not ported yet ----------------------------------------------------

def test_unported_training_paths_name_their_items(dlrm):
    run = TRun(model=dlrm["tcfg"], shape=TShape("t", "train", 1, 8))
    with pytest.raises(NotImplementedError, match="item 12"):
        TSTEPS.make_train_step(run.model, run.shape,
                               TPar(grad_compression="int8"), TOpt())
    # the dense family trains since slice 4; the other families wait
    moe = TREG.get_reduced("olmo-1b").replace(family="moe")
    with pytest.raises(NotImplementedError, match="item 11"):
        TSTEPS.loss_fn(moe, {}, {})
    with pytest.raises(NotImplementedError, match="item 11"):
        Trainer(run.replace(model=moe), device="cpu")
    # no checkpoint yet: restore finds none, save without ckpt_dir is a no-op
    tr = Trainer(run, device="cpu")
    assert tr.restore() is None
    tr.save(None)
    assert Trainer(run, device="cpu", ckpt_dir="ckpt").restore() is None
    with pytest.raises(NotImplementedError, match="item 7"):
        Trainer(run.replace(optimizer=TOpt(name="sgd")),
                device="cpu").init_state()


def test_trainer_runs_on_the_card_by_default(dlrm):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    run = TRun(model=dlrm["tcfg"], shape=TShape("t", "train", 1, 8))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(run)
