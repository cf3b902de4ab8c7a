"""Dense training of the port (reduced olmo-1b) against the JAX package.

  * ``layers``: `blocked_attention` (causal or not, windows, softcap, KV
    padding) and `blocked_attention_qchunked` forward and gradient against
    the reference's, `reference_attention` against its oracle;
  * ``transformer.forward`` / ``api.forward`` logits against
    ``repro.models.api.forward``, ``attn_impl`` blocked and qchunked, on
    reduced olmo-1b and on a windowed variant (4 layers, a window of 8
    every other layer) that exercises the static-window groups;
  * the first step's gradients against ``jax.grad`` of
    ``repro.launch.steps.loss_fn``, and a 5-step loss curve of
    ``Trainer.train`` against the reference's jitted train step, each with
    ``xent_chunk`` 0 and 8 and both ``attn_impl``s;
  * within the port, bitwise: remat on equals off, the chunked
    cross-entropy with and without its per-chunk recompute, and a loss
    curve across a preempt and a resume (on another slice's geometry)
    equals the uninterrupted one; the train CLI resumes from its
    checkpoint.

JAX params come over through ``repro_torch.interop``.  Tolerances:
  * logits: 2^-5 of the largest |logit| (the bf16 bar of ROADMAP.md);
  * attention and its gradients, and the first step's gradients: each
    within 2^-5 of the reference's largest |x|;
  * the loss curve: 1e-3 + 2^-7 |loss| at every step (the DLRM's bar).
"""
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs import registry as JREG
from repro.configs.base import AttentionConfig as JAttn
from repro.configs.base import OptimizerConfig as JOpt
from repro.configs.base import ParallelConfig as JPar
from repro.configs.base import ShapeConfig as JShape
from repro.data.synthetic import Dataset as JDataset
from repro.launch import steps as JSTEPS
from repro.models import api as JAPI
from repro.models import layers as JL
from repro.optim import adam as JOPT
from repro.parallel.context import LOCAL
from repro_torch import interop
from repro_torch.configs import registry as TREG
from repro_torch.configs.base import AttentionConfig as TAttn
from repro_torch.configs.base import OptimizerConfig as TOpt
from repro_torch.configs.base import ParallelConfig as TPar
from repro_torch.configs.base import RunConfig as TRun
from repro_torch.configs.base import ShapeConfig as TShape
from repro_torch.launch import steps as TSTEPS
from repro_torch.launch import train as TCLI
from repro_torch.models import api as TAPI
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TTF
from repro_torch.optim import adam as TOPT
from repro_torch.train.trainer import Trainer, TrainerState

REL_TOL = 2.0 ** -5
B, T = 2, 16
OCFG = dict(lr=1e-3, warmup_steps=2)


def _configs(name):
    j, t = JREG.get_reduced("olmo-1b"), TREG.get_reduced("olmo-1b")
    if name == "windowed":
        kw = dict(num_heads=4, num_kv_heads=2, head_dim=16,
                  sliding_window=8, global_every=2)
        j = j.replace(num_layers=4, attention=JAttn(**kw))
        t = t.replace(num_layers=4, attention=TAttn(**kw))
    return j, t


@pytest.fixture(scope="module")
def olmo():
    jcfg, tcfg = _configs("olmo")
    jp = JAPI.init_params(jcfg, jax.random.PRNGKey(0))
    return dict(jcfg=jcfg, tcfg=tcfg, jp=jp,
                npp=jax.tree.map(np.asarray, jp))


def _close(got, want, what=""):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy()
    assert got.shape == want.shape, (what, got.shape, want.shape)
    tol = REL_TOL * max(np.abs(want).max(), 1e-6)
    err = np.abs(got - want).max()
    assert err <= tol, f"{what}: {err} > {tol}"


def _jbatch(cfg, step=0, seq=T):
    return JDataset(cfg, JShape("t", "train", seq, B)).batch(step)


def _tbatch(nb):
    return {k: torch.from_numpy(v) for k, v in nb.items()}


# -- attention ------------------------------------------------------------------

def _qkv(seed, Tq=20, H=4, KH=2, D=16):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, Tq, h, D)).astype(np.float32)
            for h in (H, KH, KH)]


def _as_bf16(arrs):
    return ([torch.from_numpy(a).to(torch.bfloat16) for a in arrs],
            [jnp.asarray(a).astype(jnp.bfloat16) for a in arrs])


ATTN_CASES = {
    "causal": dict(causal=True),
    "window_softcap": dict(causal=True, window=6, softcap=5.0),
    "bidirectional": dict(causal=False),
}


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
@pytest.mark.parametrize("impl", ["blocked", "qchunked"])
def test_attention_and_its_gradient_match_jax(case, impl):
    """Output and d(sum(out * w))/d(q, k, v) against ``jax.grad`` of the
    reference's function on the same bf16 inputs."""
    kw = ATTN_CASES[case]
    Tq = 20 if impl == "blocked" else 24       # qchunked: aligned chunks
    (qt, kt, vt), (qj, kj, vj) = _as_bf16(_qkv(1, Tq))
    pos = np.broadcast_to(np.arange(Tq, dtype=np.int32), (B, Tq))
    w = np.random.default_rng(2).standard_normal(
        (B, Tq, 4, 16)).astype(np.float32)
    if impl == "blocked":
        chunks = dict(kv_chunk=8)               # 20 lanes: a padded chunk
        tf, jf = TL.blocked_attention, JL.blocked_attention
    else:
        chunks = dict(q_chunk=8, kv_chunk=4)    # pairs pruned by mask
        tf, jf = TL.blocked_attention_qchunked, JL.blocked_attention_qchunked

    def jloss(q, k, v):
        o = jf(q, k, v, jnp.asarray(pos), jnp.asarray(pos), **kw, **chunks)
        return (o.astype(jnp.float32) * w).sum(), o

    (_, jo), jg = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                             has_aux=True))(qj, kj, vj)
    ins = [x.clone().requires_grad_(True) for x in (qt, kt, vt)]
    to = tf(*ins, torch.from_numpy(pos.copy()), torch.from_numpy(pos.copy()),
            **kw, **chunks)
    assert to.dtype == torch.bfloat16
    (to.float() * torch.from_numpy(w)).sum().backward()
    _close(to, jo.astype(jnp.float32), "out")
    for name, x, g in zip("qkv", ins, jg):
        assert x.grad.dtype == torch.bfloat16
        _close(x.grad, g.astype(jnp.float32), f"d{name}")


def test_reference_attention_matches_jax_oracle():
    (qt, kt, vt), (qj, kj, vj) = _as_bf16(_qkv(3))
    qpos = np.broadcast_to(np.arange(20, dtype=np.int32), (B, 20)).copy()
    kvpos = qpos.copy()
    kvpos[1, -3:] = -1                          # masked kv lanes
    tpos = (torch.from_numpy(qpos), torch.from_numpy(kvpos))
    jpos = (jnp.asarray(qpos), jnp.asarray(kvpos))
    for kw in (dict(), dict(window=5, softcap=3.0), dict(causal=False)):
        got = TL.reference_attention(qt, kt, vt, *tpos, **kw)
        want = JL.reference_attention(qj, kj, vj, *jpos, **kw)
        _close(got, want.astype(jnp.float32), str(kw))
        # the blocked form computes the same function
        blk = TL.blocked_attention(qt, kt, vt, *tpos, kv_chunk=8, **kw)
        _close(blk, want.astype(jnp.float32), f"blocked {kw}")


# -- forward ----------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["blocked", "qchunked"])
@pytest.mark.parametrize("name", ["olmo", "windowed"])
def test_forward_logits_match_jax(name, impl):
    jcfg, tcfg = _configs(name)
    jp = JAPI.init_params(jcfg, jax.random.PRNGKey(1))
    tp = interop.params_from_numpy(jax.tree.map(np.asarray, jp))
    toks = np.random.default_rng(4).integers(
        0, jcfg.vocab_size, (B, T)).astype(np.int32)
    want, jaux = jax.jit(lambda p, t: JAPI.forward(
        jcfg, p, {"tokens": t}, LOCAL, attn_impl=impl, kv_chunk=8))(
            jp, jnp.asarray(toks))
    got, aux = TAPI.forward(tcfg, tp, {"tokens": torch.from_numpy(toks)},
                            attn_impl=impl, kv_chunk=8)
    assert got.dtype == torch.float32 and float(aux) == float(jaux) == 0.0
    _close(got, want, "logits")
    hidden, _ = TAPI.forward(tcfg, tp, {"tokens": torch.from_numpy(toks)},
                             attn_impl=impl, kv_chunk=8, return_hidden=True)
    assert tuple(hidden.shape) == (B, T, tcfg.d_model)


def test_static_window_groups_match_reference():
    from repro.models import transformer as JTF
    for name in ("olmo", "windowed"):
        jcfg, tcfg = _configs(name)
        assert TTF.attn_group_size(tcfg) == JTF.attn_group_size(jcfg)
        assert TTF.can_qchunk(tcfg) == JTF.can_qchunk(jcfg)
        g = TTF.attn_group_size(tcfg)
        for i in range(g):
            assert TTF.static_window_for(tcfg, i, g) == \
                JTF.static_window_for(jcfg, i, g)
    assert TTF.attn_group_size(_configs("windowed")[1]) == 2
    # a local/global pattern that does not tile the stack cannot qchunk
    odd = _configs("windowed")[1].replace(num_layers=3)
    assert not TTF.can_qchunk(odd) and TTF.attn_group_size(odd) == 1


# -- the first step and the loss curve --------------------------------------------

COMBOS = [(0, "blocked"), (8, "blocked"), (0, "qchunked"), (8, "qchunked")]


@pytest.fixture(scope="module")
def jref(olmo):
    """(xent_chunk, impl) -> the reference's first-step loss, metrics and
    gradients (``jax.grad`` of ``loss_fn``) and its 5-step loss curve (its
    train step), from ONE jitted function a combination: XLA compiles the
    gradient and the step together, and both tests read the result."""
    jcfg, cache = olmo["jcfg"], {}

    def get(xent_chunk, impl):
        if (xent_chunk, impl) in cache:
            return cache[xent_chunk, impl]
        step = JSTEPS.make_train_step(
            jcfg, JShape("t", "train", T, B),
            JPar(remat="none", xent_chunk=xent_chunk, attn_impl=impl),
            JOpt(**OCFG), LOCAL)

        def both(p, o, nb):
            vg = jax.value_and_grad(
                lambda q: JSTEPS.loss_fn(jcfg, q, nb, LOCAL,
                                         xent_chunk=xent_chunk,
                                         attn_impl=impl), has_aux=True)(p)
            return vg, step(p, o, nb)

        fn = jax.jit(both)
        jp, jo = olmo["jp"], JOPT.init(JOpt(**OCFG), olmo["jp"])
        curve = []
        for s in range(5):
            vg, (jp, jo, m) = fn(jp, jo, _jbatch(jcfg, s))
            if s == 0:
                first = vg
            curve.append(float(m["loss"]))
        cache[xent_chunk, impl] = dict(first=first, curve=curve)
        return cache[xent_chunk, impl]

    return get


@pytest.mark.parametrize("xent_chunk,impl", COMBOS)
def test_first_step_gradients_match_jax(olmo, jref, xent_chunk, impl):
    tcfg = olmo["tcfg"]
    nb = _jbatch(olmo["jcfg"])
    (jloss, jm), jg = jref(xent_chunk, impl)["first"]
    tp = interop.params_from_numpy(olmo["npp"])
    pcfg = TPar(remat="none", xent_chunk=xent_chunk, attn_impl=impl)
    metrics, tg = TSTEPS.value_and_grad(tcfg, pcfg, tp, _tbatch(nb))
    assert set(metrics) == set(jm) == {"loss", "aux"}
    assert abs(metrics["loss"].item() - float(jloss)) <= \
        1e-3 + 2.0 ** -7 * abs(float(jloss))
    jl = jax.tree.leaves(jg)
    assert len(tg) == len(jl)
    for i, (got, want) in enumerate(zip(tg, jl)):
        assert got.dtype == torch.float32
        _close(got, want, f"leaf {i}")
    # the params never require a gradient: the views did
    assert not any(p.requires_grad for p in TOPT.leaves(tp))


def _jax_curve(jcfg, jp, steps, xent_chunk, impl, accum=None):
    jstep = jax.jit(JSTEPS.make_train_step(
        jcfg, JShape("t", "train", T, B),
        JPar(remat="none", xent_chunk=xent_chunk, attn_impl=impl),
        JOpt(**OCFG), LOCAL, accum_steps=accum))
    jo = JOPT.init(JOpt(**OCFG), jp)
    out = []
    for s in range(steps):
        jp, jo, m = jstep(jp, jo, _jbatch(jcfg, s))
        out.append(float(m["loss"]))
    return out


def _run(tcfg, xent_chunk=0, impl="blocked", remat="none"):
    return TRun(model=tcfg, shape=TShape("t", "train", T, B),
                parallel=TPar(remat=remat, xent_chunk=xent_chunk,
                              attn_impl=impl),
                optimizer=TOpt(**OCFG))


@pytest.mark.parametrize("xent_chunk,impl", COMBOS)
def test_loss_curve_matches_jax_train_step(olmo, jref, xent_chunk, impl):
    """5 steps from the same params and Dataset batches: Trainer.train
    against the reference's jitted train step."""
    want = jref(xent_chunk, impl)["curve"]
    run = _run(olmo["tcfg"], xent_chunk, impl)
    tr = Trainer(run, device="cpu")
    tp = interop.params_from_numpy(olmo["npp"])
    state = tr.train(5, state=TrainerState(tp, TOPT.init(run.optimizer, tp),
                                           0), log_every=1)
    got = [m["loss"] for m in tr.metrics_log]
    assert [m["step"] for m in tr.metrics_log] == [1, 2, 3, 4, 5]
    for g, w in zip(got, want):
        assert abs(g - w) <= 1e-3 + 2.0 ** -7 * abs(w), (got, want)
    assert state.step == state.opt_state.step == 5


def test_accumulated_loss_matches_jax_train_step(olmo):
    """Two microbatches a step, as pick_accum_steps gives the full-width
    cell: the accumulated loss and its curve against the reference's."""
    want = _jax_curve(olmo["jcfg"], olmo["jp"], 2, 8, "blocked", accum=2)
    run = _run(olmo["tcfg"], 8)
    tr = Trainer(run, device="cpu", accum_steps=2)
    tp = interop.params_from_numpy(olmo["npp"])
    tr.train(2, state=TrainerState(tp, TOPT.init(run.optimizer, tp), 0),
             log_every=1)
    got = [m["loss"] for m in tr.metrics_log]
    for g, w in zip(got, want):
        assert abs(g - w) <= 1e-3 + 2.0 ** -7 * abs(w), (got, want)


# -- bitwise within the port ----------------------------------------------------------

@pytest.mark.parametrize("xent_chunk,impl", [(0, "blocked"), (8, "qchunked")])
def test_remat_on_equals_off_bitwise(olmo, xent_chunk, impl):
    tcfg = olmo["tcfg"]
    batch = _tbatch(_jbatch(olmo["jcfg"]))
    out = {}
    for remat in ("none", "block"):
        tp = interop.params_from_numpy(olmo["npp"])
        out[remat] = TSTEPS.value_and_grad(
            tcfg, TPar(remat=remat, xent_chunk=xent_chunk, attn_impl=impl),
            tp, batch)
    (m0, g0), (m1, g1) = out["none"], out["block"]
    assert torch.equal(m0["loss"], m1["loss"])
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))


def test_xent_chunk_recompute_is_bitwise(olmo):
    """The loss's per-chunk recompute changes what the graph keeps, not a
    bit of the loss or its gradient: against the same chunks summed with
    every chunk's logits kept in the graph."""
    tcfg = olmo["tcfg"]
    nb = _jbatch(olmo["jcfg"])
    tp = interop.params_from_numpy(olmo["npp"])
    x, _ = TAPI.forward(tcfg, tp, {"tokens": torch.from_numpy(nb["tokens"])},
                        return_hidden=True)
    x = x.detach()
    labels = torch.from_numpy(nb["labels"])
    B, T, _ = x.shape
    res = []
    for recompute in (True, False):
        xv = x.clone().requires_grad_(True)
        emb = tp["embed"].detach().clone().requires_grad_(True)
        if recompute:
            loss = TSTEPS._xent_chunked(tcfg, {"embed": emb}, xv, labels, 4)
        else:
            tot = torch.zeros((), dtype=torch.float32)
            for c0 in range(0, T, 4):
                tot = tot + TSTEPS._chunk_xent_sum(
                    tcfg, {"embed": emb}, xv[:, c0:c0 + 4],
                    labels[:, c0:c0 + 4])
            loss = tot / (B * T)
        res.append((loss, *torch.autograd.grad(loss, [xv, emb])))
    assert all(torch.equal(a, b) for a, b in zip(*res))
    whole = TSTEPS._xent(TTF.unembed(tcfg, tp, x), labels)
    assert abs(res[0][0].item() - whole.item()) <= 1e-5 * abs(whole.item())


def test_preempt_and_resume_on_another_slice_is_bitwise(olmo, tmp_path):
    """Preempted at step 3 (checkpointed), resumed by a fresh Trainer that
    records another slice geometry: the loss curve is bitwise the
    uninterrupted run's, and so are the final params."""
    run = _run(olmo["tcfg"], 8, remat="block")
    clean = Trainer(run, device="cpu")
    cstate = clean.train(6, log_every=1)
    want = [m["loss"] for m in clean.metrics_log]
    first = Trainer(run, device="cpu", ckpt_dir=str(tmp_path),
                    slice_dims=(8, 8, 8), ckpt_every=100)
    st = first.train(6, preempt_at=3, log_every=1)
    assert first.preempted and st.step == 3
    second = Trainer(run, device="cpu", ckpt_dir=str(tmp_path),
                     slice_dims=(4, 4, 8))
    st = second.train(6, log_every=1)
    got = ([m["loss"] for m in first.metrics_log if "loss" in m]
           + [m["loss"] for m in second.metrics_log])
    assert got == want
    assert all(torch.equal(a, b) for a, b in
               zip(TOPT.leaves(st.params), TOPT.leaves(cstate.params)))
    assert st.opt_state.step == 6
    from repro_torch.train import checkpoint as CKPT
    assert CKPT.read_manifest(str(tmp_path), 3)["extra"]["slice_dims"] == \
        [8, 8, 8]


def test_trainer_trains_f32_master_weights(olmo):
    tr = Trainer(_run(olmo["tcfg"]), device="cpu")
    st = tr.init_state()
    leaves = TOPT.leaves(st.params)
    assert all(p.dtype == torch.float32 for p in leaves)
    before = [p.clone() for p in leaves]
    st = tr.train(2, state=st, log_every=1)
    assert all(not torch.equal(a, b) and not b.requires_grad
               for a, b in zip(before, TOPT.leaves(st.params)))
    assert all(np.isfinite(m["loss"]) for m in tr.metrics_log)
    assert set(tr.metrics_log[-1]) >= {"loss", "aux", "grad_norm", "lr",
                                       "wire_bytes", "step", "wall_s"}


def test_cli_trains_reduced_olmo_and_resumes(tmp_path, capsys):
    argv = ["--arch", "olmo-1b", "--reduced", "--device", "cpu",
            "--steps", "4", "--batch", "2", "--seq", "16",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    log = TCLI.main(argv)
    assert [m["step"] for m in log] == [1, 2, 3, 4]
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert lines == log and all(np.isfinite(m["loss"]) for m in log)
    # a second call restores step 4 and has nothing left to run
    assert TCLI.main(argv) == []
