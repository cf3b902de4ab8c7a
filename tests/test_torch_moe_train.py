"""MoE training of the port (reduced qwen3-moe and kimi-k2) against the
JAX package.

  * the MoE layer's vector-Jacobian product: ``moe_local``'s gradients
    with respect to ``x``, the router, the experts and the shared experts
    against ``jax.vjp`` of the reference's ``moe_local``, at bf16 and at
    f32 compute;
  * the first step's gradients of ``steps.loss_fn`` (ce + 0.01 aux)
    against ``jax.value_and_grad`` of the reference's ``loss_fn``;
  * a 5-step loss curve of the port's ``Trainer`` against the reference's
    jitted train step (what its ``Trainer`` runs; one jit with the
    first-step gradient, so XLA compiles them together), and two
    microbatches a step against the reference's accumulating step;
  * within the port, bitwise: remat on equals off, the step under
    ``torch.use_deterministic_algorithms`` equals the default one, a
    preempt/resume on another geometry equals the uninterrupted run, and
    ``Slice.train`` equals ``Trainer``;
  * format-v2 checkpoints of a MoE tree (stacked ``moe`` leaves, kimi-k2's
    ``dense_prefix``, Adam's and adafactor's state) written by the
    reference's ``Trainer`` into the port's ``Trainer``, and back, every
    leaf bitwise;
  * the CLI trains reduced qwen3-moe with ``--optimizer adafactor``.

Routing.  The router's logits are a bf16 product, so near ties between
experts are common, and a last-bit difference in the hidden state picks
another expert; a whole-model gradient then measures routing noise (half
of max|g| on a leaf), not the backward.  JAX's jitted routes are not its
eager (``disable_jit``) routes either.  So where a test holds gradients
to the reference, the routes are recorded INSIDE the jitted JAX
computation (a ``jax.debug.callback(ordered=True)`` on the expert ids
that ``repro.models.moe.router_topk`` returns) and replayed into the
port's ``router_topk``, which then computes its gates and aux loss from
its own probabilities.  At f32 compute no replay is needed: the routes
must be equal, and the test reports the smallest margin between a
token's k-th and (k+1)-th logits.  The loss curves run with no replay.

Tolerances: each gradient leaf within REL_TOL = 2^-5 of the reference's
largest |g| (the logits bar of ROADMAP.md); losses and aux within
1e-3 + 2^-7 |x|; checkpoints exact.
"""
import contextlib
import json

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
from repro.launch.mesh import make_local_mesh
from repro.models import moe as JM
from repro.optim import adam as JOPT
from repro.parallel.context import LOCAL
from repro.train import checkpoint as JCKPT
from repro.train.trainer import Trainer as JTrainer
from repro.train.trainer import TrainerState as JTrainerState
from repro_torch import interop
from repro_torch.cluster import Supercomputer
from repro_torch.configs import registry as TREG
from repro_torch.configs.base import OptimizerConfig as TOpt
from repro_torch.configs.base import ParallelConfig as TPar
from repro_torch.configs.base import RunConfig as TRun
from repro_torch.configs.base import ShapeConfig as TShape
from repro_torch.launch import steps as TSTEPS
from repro_torch.launch import train as TCLI
from repro_torch.models import api as TAPI
from repro_torch.models import moe as TM
from repro_torch.optim import adam as TOPT
from repro_torch.train import checkpoint as CKPT
from repro_torch.train.trainer import Trainer, TrainerState

ARCHS = ("qwen3-moe-30b-a3b", "kimi-k2-1t-a32b")
REL_TOL = 2.0 ** -5
B, T = 4, 32
OCFG = dict(lr=1e-3, warmup_steps=2)
CURVE_STEPS = 5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The reduced models' ops are tiny: one intra-op thread runs them
    fastest, and leaves the other test workers their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _loss_close(got, want):
    return abs(got - want) <= 1e-3 + 2.0 ** -7 * abs(want)


def _close(got, want, what=""):
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    got = got.detach().float().numpy()
    assert got.shape == want.shape, (what, got.shape, want.shape)
    tol = REL_TOL * max(np.abs(want).max(), 1e-6)
    err = np.abs(got - want).max()
    assert err <= tol, f"{what}: {err} > {tol} ({err / tol:.3f} of the bar)"


# -- routes: recorded inside the jitted JAX computation, replayed in the port -

@contextlib.contextmanager
def jax_routes():
    """The expert ids of every ``repro.models.moe.router_topk`` call that a
    JAX computation traced inside (while ``_TRACE_ROUTES[0]`` is set) runs,
    in order, as numpy (S, k)."""
    calls, orig = [], JM.router_topk

    def rec(cfg, p, x, dtype=jnp.bfloat16):
        g, e, a = orig(cfg, p, x, dtype)
        if _TRACE_ROUTES[0]:
            jax.debug.callback(lambda ids: calls.append(np.array(ids)), e,
                               ordered=True)
        return g, e, a

    JM.router_topk = rec
    try:
        yield calls
    finally:
        JM.router_topk = orig


def _replayed_router(cfg, p, x, dtype, eidx):
    """The port's router with the expert ids ``eidx`` given: gates and aux
    from the port's own probabilities."""
    m = cfg.moe
    logits = TM._mm(x, p["router"], dtype).float()
    if m.router_softcap:
        logits = m.router_softcap * torch.tanh(logits / m.router_softcap)
    probs = torch.softmax(logits, dim=-1)
    gates = probs.gather(1, eidx)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    ce = torch.nn.functional.one_hot(eidx[:, 0], m.num_experts).float()
    aux = m.num_experts * torch.sum(probs.mean(dim=0) * ce.mean(dim=0))
    return gates, eidx, aux


@contextlib.contextmanager
def port_routes(replay=None):
    """Record the port's expert ids (and each token's k-th/(k+1)-th logit
    margin) per ``router_topk`` call; with ``replay``, a list of recorded
    ids, each call takes the next one instead of its own top-k."""
    calls, orig = [], TM.router_topk
    todo = iter(replay) if replay is not None else None

    def rec(cfg, p, x, dtype=torch.bfloat16):
        ids = (None if todo is None
               else torch.from_numpy(next(todo)).long().to(x.device))
        g, e, a = (orig(cfg, p, x, dtype) if ids is None
                   else _replayed_router(cfg, p, x, dtype, ids))
        with torch.no_grad():
            lg = TM._mm(x, p["router"], dtype).float()
        srt = lg.sort(dim=1, descending=True).values
        k = cfg.moe.top_k
        calls.append(dict(ids=e.cpu().numpy(),
                          margin=(srt[:, k - 1] - srt[:, k]).numpy()))
        return g, e, a

    TM.router_topk = rec
    try:
        yield calls
    finally:
        TM.router_topk = orig
    if todo is not None:
        assert next(todo, None) is None, "a recorded route was not replayed"


# -- the MoE layer's VJP ------------------------------------------------------

def _flat(tree):
    return jax.tree.leaves(tree)


@pytest.mark.parametrize("compute", ["bf16", "f32"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_layer_vjp_matches_jax(arch, compute, record_property):
    """``moe_local``'s output, aux and gradients (x, router, wg/wu/wo, the
    shared expert) against ``jax.vjp`` of the reference's, for a random
    cotangent of the output and of aux.  S = 64 tokens at capacity 20:
    some pairs drop."""
    jcfg, tcfg = JREG.get_reduced(arch), TREG.get_reduced(arch)
    npp = jax.tree.map(np.asarray, JM.moe_init(jcfg, jax.random.PRNGKey(3)))
    rng = np.random.default_rng(7)
    S, d = 64, jcfg.d_model
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if compute == "bf16"
                else (jnp.float32, torch.float32))
    x = jnp.asarray(rng.standard_normal((S, d)), jnp.float32).astype(jdt)
    ct = jnp.asarray(rng.standard_normal((S, d)), jnp.float32).astype(jdt)
    ct_aux = jnp.float32(0.37)

    def jfn(x, p, ct, ct_aux):
        (out, aux), vjp = jax.vjp(
            lambda x, p: JM.moe_local(jcfg, p, x, dtype=jdt)[:2], x, p)
        return out, aux, vjp((ct, ct_aux))

    _TRACE_ROUTES[0] = True
    try:
        with jax_routes() as jids:
            jout, jaux, (jgx, jgp) = jax.jit(jfn)(x, npp, ct, ct_aux)
    finally:
        _TRACE_ROUTES[0] = False
    assert len(jids) == 1
    tx = torch.from_numpy(np.array(x.astype(jnp.float32))).to(tdt)
    tp = interop.params_from_numpy(npp)
    tx.requires_grad_(True)
    for leaf in TOPT.leaves(tp):
        leaf.requires_grad_(True)
    with port_routes(jids if compute == "bf16" else None) as tids:
        out, aux, _ = TM.moe_local(tcfg, tp, tx, dtype=tdt)
    if compute == "f32":
        # no ties at f32: the port routes as JAX does, unaided
        np.testing.assert_array_equal(tids[0]["ids"], jids[0])
        margin = float(tids[0]["margin"].min())
        record_property("min_topk_margin_f32", margin)
        assert margin > 0
    tct = torch.from_numpy(np.array(ct.astype(jnp.float32))).to(tdt)
    grads = torch.autograd.grad((out, aux), [tx] + TOPT.leaves(tp),
                                (tct, torch.tensor(0.37)))
    assert out.dtype == tdt
    _close(out, jout, "out")
    assert _loss_close(aux.item(), float(jaux))
    _close(grads[0], jgx, "dx")
    names = [jax.tree_util.keystr(k) for k, _ in
             jax.tree_util.tree_flatten_with_path(jgp)[0]]
    assert len(grads) - 1 == len(names) and ("['router']" in names)
    for name, g, w in zip(names, grads[1:], _flat(jgp)):
        _close(g, w, name)


# -- whole-model first-step gradients, the loss curve -------------------------

def _run(tcfg, *, opt="adam", remat="none", xent_chunk=0, seq=T, batch=B):
    return TRun(model=tcfg, shape=TShape("t", "train", seq, batch),
                parallel=TPar(remat=remat, xent_chunk=xent_chunk),
                optimizer=TOpt(name=opt, **OCFG))


def _jrun(jcfg, *, opt="adam", seq=T, batch=B):
    return JRun(model=jcfg, shape=JShape("t", "train", seq, batch),
                parallel=JPar(remat="none"),
                optimizer=JOpt(name=opt, **OCFG))


_TRACE_ROUTES = [False]     # jax_routes records only while this is set


def _jax_side(jcfg, npp, steps):
    """The reference's first-step ``jax.value_and_grad`` of ``loss_fn`` on
    batch 0 (its routes recorded) and ``steps`` Adam steps of its jitted
    train step (what its ``Trainer`` runs) from ``npp``, in ONE jitted
    function (XLA compiles the two together).  Returns (first, routes, the
    final params and optimizer state, the losses)."""
    run = _jrun(jcfg)
    step = JSTEPS.make_train_step(jcfg, run.shape, run.parallel,
                                  run.optimizer, LOCAL)

    def both(p, o, nb):
        _TRACE_ROUTES[0] = True
        vg = jax.value_and_grad(
            lambda q: JSTEPS.loss_fn(jcfg, q, nb, LOCAL), has_aux=True)(p)
        _TRACE_ROUTES[0] = False
        return vg, step(p, o, nb)

    fn = jax.jit(both)
    jp = jax.tree.map(jnp.asarray, npp)
    jo = JOPT.init(run.optimizer, jp)
    curve = []
    with jax_routes() as calls:
        for s in range(steps):
            vg, (jp, jo, m) = fn(jp, jo, _jbatch(jcfg, s))
            if s == 0:
                # every later call runs the callbacks again: keep the first
                jax.effects_barrier()
                first, routes = vg, list(calls)
            curve.append(float(m["loss"]))
    return first, routes, (jp, jo), curve


def _jbatch(jcfg, step):
    return JDataset(jcfg, JShape("t", "train", T, B)).batch(step)


def _jsave(jcfg, ckpt_dir, params, opt_state, step, opt="adam"):
    """A checkpoint written by the reference's ``Trainer.save``."""
    JTrainer(_jrun(jcfg, opt=opt), make_local_mesh(),
             ckpt_dir=ckpt_dir).save(JTrainerState(params, opt_state, step))


@pytest.fixture(scope="module")
def moe_ref(tmp_path_factory):
    """arch -> random f32 params in the reference's layout (numpy); the
    first step's loss, metrics and gradients of ``jax.value_and_grad`` of
    its ``loss_fn`` on batch 0, with the routes that jitted computation
    took; its 5-step loss curve, the state after it checkpointed by the
    reference's ``Trainer`` (step 5, Adam's state); each arch built
    once."""
    cache = {}

    def get(arch):
        if arch in cache:
            return cache[arch]
        jcfg, tcfg = JREG.get_reduced(arch), TREG.get_reduced(arch)
        # random f32 weights in the reference's layout, made by the port
        # (JAX's own init takes seconds here; both sides get these)
        npp = TOPT.tree_map(lambda t: t.numpy(), TAPI.init_params(
            tcfg, seed=0, device="cpu", dtype=torch.float32))
        first, routes, (jp, jo), curve = _jax_side(jcfg, npp, CURVE_STEPS)
        ckpt = str(tmp_path_factory.mktemp("moe_adam"))
        jstate = JTrainerState(jp, jo, CURVE_STEPS)
        _jsave(jcfg, ckpt, jp, jo, CURVE_STEPS)
        cache[arch] = dict(arch=arch, jcfg=jcfg, tcfg=tcfg, npp=npp,
                           curve=curve, ckpt=ckpt, jstate=jstate,
                           nb=_jbatch(jcfg, 0), first=first,
                           routes=routes)
        return cache[arch]

    return get


def _tbatch(nb):
    return {k: torch.from_numpy(v) for k, v in nb.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_first_step_gradients_match_jax_with_replayed_routes(moe_ref, arch):
    """``steps.value_and_grad`` (ce + 0.01 aux) against
    ``jax.value_and_grad`` of the reference's ``loss_fn`` on the same
    params and batch, every MoE layer taking the routes JAX took."""
    moe = moe_ref(arch)
    tcfg = moe["tcfg"]
    (jloss, jm), jg = moe["first"]
    n_moe = tcfg.num_layers - tcfg.moe.dense_layers
    assert len(moe["routes"]) == n_moe
    tp = interop.params_from_numpy(moe["npp"])
    with port_routes(moe["routes"]):
        metrics, tg = TSTEPS.value_and_grad(tcfg, TPar(remat="none"), tp,
                                            _tbatch(moe["nb"]))
    assert set(metrics) == set(jm) == {"loss", "aux"}
    assert _loss_close(metrics["loss"].item(), float(jm["loss"]))
    assert _loss_close(metrics["aux"].item(), float(jm["aux"]))
    assert float(jm["aux"]) > 0
    leaves = jax.tree_util.tree_flatten_with_path(jg)[0]
    assert len(tg) == len(leaves)
    for (path, want), got in zip(leaves, tg):
        assert got.dtype == torch.float32
        _close(got, want, jax.tree_util.keystr(path))
    assert not any(p.requires_grad for p in TOPT.leaves(tp))


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_curve_matches_jax_trainer(moe_ref, arch):
    """5 steps from the same params and batches, with no replay: the
    port's Trainer against the reference's jitted train step."""
    moe = moe_ref(arch)
    run = _run(moe["tcfg"])
    tr = Trainer(run, device="cpu")
    tp = interop.params_from_numpy(moe["npp"])
    st = tr.train(CURVE_STEPS, state=TrainerState(
        tp, TOPT.init(run.optimizer, tp), 0), log_every=1)
    got = [m["loss"] for m in tr.metrics_log]
    assert len(got) == CURVE_STEPS and st.step == CURVE_STEPS
    assert all(_loss_close(g, w) for g, w in zip(got, moe["curve"])), \
        (got, moe["curve"])
    assert all(m["aux"] > 0 for m in tr.metrics_log)


def test_accumulated_moe_loss_matches_jax_train_step(moe_ref):
    """Two microbatches a step: each MoE call's capacity counts its
    microbatch's tokens, and the logged loss is the accumulated
    ce + 0.01 aux, as the reference's accumulating step."""
    moe = moe_ref(ARCHS[0])
    jcfg, tcfg = moe["jcfg"], moe["tcfg"]
    jstep = jax.jit(JSTEPS.make_train_step(
        jcfg, JShape("t", "train", T, B), JPar(remat="none"), JOpt(**OCFG),
        LOCAL, accum_steps=2))
    jp = jax.tree.map(jnp.asarray, moe["npp"])
    jo = JOPT.init(JOpt(**OCFG), jp)
    want = []
    for s in range(2):
        jp, jo, m = jstep(jp, jo, _jbatch(jcfg, s))
        want.append(float(m["loss"]))
    caps = []
    orig = TM.capacity_for

    def cap(tokens, m, factor):
        caps.append(tokens)
        return orig(tokens, m, factor)

    run = _run(tcfg)
    tr = Trainer(run, device="cpu", accum_steps=2)
    tp = interop.params_from_numpy(moe["npp"])
    TM.capacity_for = cap
    try:
        tr.train(2, state=TrainerState(tp, TOPT.init(run.optimizer, tp), 0),
                 log_every=1)
    finally:
        TM.capacity_for = orig
    assert set(caps) == {B // 2 * T}
    got = [m["loss"] for m in tr.metrics_log]
    assert all(_loss_close(g, w) for g, w in zip(got, want)), (got, want)


# -- bitwise within the port --------------------------------------------------

def _step_bits(tcfg, pcfg, npp, nb):
    m, g = TSTEPS.value_and_grad(tcfg, pcfg, interop.params_from_numpy(npp),
                                 _tbatch(nb))
    return [m["loss"], m["aux"]] + g


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_and_deterministic_mode_are_bitwise(moe_ref, arch):
    """One step's loss, aux and gradients: remat on equals off, and the
    step under ``torch.use_deterministic_algorithms`` equals the default
    one (an op with no deterministic form would raise in there)."""
    moe = moe_ref(arch)
    tcfg, npp, nb = moe["tcfg"], moe["npp"], moe["nb"]
    base = _step_bits(tcfg, TPar(remat="none", xent_chunk=8), npp, nb)
    remat = _step_bits(tcfg, TPar(remat="block", xent_chunk=8), npp, nb)
    assert all(torch.equal(a, b) for a, b in zip(base, remat))
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        det = _step_bits(tcfg, TPar(remat="none", xent_chunk=8), npp, nb)
    finally:
        torch.use_deterministic_algorithms(was)
    assert all(torch.equal(a, b) for a, b in zip(base, det))


def _autograd_grads(tcfg, pcfg, tp, batch):
    """The microbatch's whole gradients by ``torch.autograd.grad`` over
    detached views of the stacked leaves (no accumulator, no per-layer
    split): the plain form `accumulate_grad` must equal."""
    views = TOPT.tree_map(lambda p: p.detach().requires_grad_(True), tp)
    loss, _ = TSTEPS.loss_fn(tcfg, views, batch, pcfg)
    return torch.autograd.grad(loss, TOPT.leaves(views))


@pytest.mark.parametrize("arch", ARCHS)
def test_accumulation_into_the_buffer_is_bitwise_the_sum(moe_ref, arch):
    """``steps.accumulate_grad`` (the first microbatch's share filling the
    accumulator, the next added into it as autograd finishes it, per
    layer of the stack) equals the reference's ``acc + g / accum`` over
    whole gradients, bit for bit, with remat and the chunked
    cross-entropy; at scale 1 (``value_and_grad``) it is the gradient."""
    moe = moe_ref(arch)
    tcfg, pcfg = moe["tcfg"], TPar(remat="block", xent_chunk=8)
    tp = interop.params_from_numpy(moe["npp"])
    batch = _tbatch(moe["nb"])
    whole = [torch.zeros(p.shape) for p in TOPT.leaves(tp)]
    into = [None] * len(whole)
    for i in range(2):
        part = {k: v[i * B // 2:(i + 1) * B // 2] for k, v in batch.items()}
        g = _autograd_grads(tcfg, pcfg, tp, part)
        for a, x in zip(whole, g):
            a.add_(x / 2)
        m = TSTEPS.accumulate_grad(tcfg, pcfg, tp, part, into, 0.5)
        assert set(m) == {"loss", "aux"}
        if i == 0:
            _, one = TSTEPS.value_and_grad(tcfg, pcfg, tp, part)
            assert all(torch.equal(a, b) for a, b in zip(g, one))
    assert all(torch.equal(a, b) for a, b in zip(whole, into))
    assert not any(p.requires_grad or p.grad is not None
                   for p in TOPT.leaves(tp))


@pytest.mark.parametrize("arch", ARCHS)
def test_preempt_and_resume_on_another_slice_is_bitwise(moe_ref, arch,
                                                        tmp_path):
    """Remat, chunked cross-entropy, two microbatches a step: preempted
    at step 3 through ``Slice.request_preempt``, resumed on a slice of
    another shape; the loss curve and the final params are bitwise the
    uninterrupted run's."""
    moe = moe_ref(arch)
    run = _run(moe["tcfg"], remat="block", xent_chunk=8)
    clean = Trainer(run, device="cpu", accum_steps=2)
    cstate = clean.train(5, log_every=1)
    want = [m["loss"] for m in clean.metrics_log]
    sc = Supercomputer(device="cpu")
    first = sc.allocate((8, 8, 8))
    sess = first.train(run, ckpt_dir=str(tmp_path), accum_steps=2)
    sess.run(3, log_every=1)
    first.request_preempt()
    sess.run(5, log_every=1)
    assert sess.preempted and sess.state.step == 3
    first.free()
    resumed = sc.allocate((4, 8, 8)).train(run, 5, ckpt_dir=str(tmp_path),
                                           accum_steps=2, log_every=1)
    got = ([m["loss"] for m in sess.metrics_log if "loss" in m]
           + [m["loss"] for m in resumed.metrics_log if "loss" in m])
    assert got == want
    assert all(torch.equal(a, b) for a, b in
               zip(TOPT.leaves(resumed.params), TOPT.leaves(cstate.params)))


@pytest.mark.parametrize("arch", ARCHS)
def test_slice_train_trains_moe_as_the_trainer(moe_ref, arch):
    """``Supercomputer(device="cpu")`` -> ``Slice.train`` trains the MoE
    family with no change of its own: f32 master weights, the same
    losses and params as a bare ``Trainer``, bit for bit."""
    moe = moe_ref(arch)
    run = _run(moe["tcfg"])
    bare = Trainer(run, device="cpu").train(2, log_every=1)
    sess = Supercomputer(device="cpu").allocate((4, 4, 4)).train(
        run, 2, log_every=1)
    assert all(p.dtype == torch.float32 for p in TOPT.leaves(sess.params))
    assert all(torch.equal(a, b) for a, b in
               zip(TOPT.leaves(sess.params), TOPT.leaves(bare.params)))


# -- checkpoints of a MoE tree, both ways -------------------------------------

def _bits(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


def _same_tree(jtree, ttree):
    jl, tl = jax.tree.leaves(jtree), TOPT.leaves(ttree)
    assert len(jl) == len(tl) > 0
    for a, b in zip(jl, tl):
        a, b = _bits(a), _bits(b)
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def adafactor_ckpt(moe_ref, tmp_path_factory):
    """Reduced qwen3-moe after one reference adafactor ``apply`` of the
    first step's gradients, checkpointed by its ``Trainer`` at step 1
    (``mu`` None, factored ``nu``)."""
    moe = moe_ref(ARCHS[0])
    ocfg = JOpt(name="adafactor", **OCFG)
    jp = jax.tree.map(jnp.asarray, moe["npp"])
    jp, jo, _ = jax.jit(lambda p, g: JOPT.apply(ocfg, p, g, JOPT.init(
        ocfg, p)))(jp, moe["first"][1])
    d = str(tmp_path_factory.mktemp("moe_adafactor"))
    _jsave(moe["jcfg"], d, jp, jo, 1, "adafactor")
    return d, JTrainerState(jp, jo, 1)


# (arch, optimizer): Adam's state on both archs (kimi-k2's dense_prefix
# list), adafactor's (mu None, factored nu) on qwen3-moe
CKPT_CASES = [(ARCHS[0], "adam"), (ARCHS[1], "adam"), (ARCHS[0], "adafactor")]


def _ckpt_case(moe, adafactor_ckpt, opt):
    if opt == "adam":
        return moe["ckpt"], moe["jstate"], CURVE_STEPS
    return adafactor_ckpt + (1,)


@pytest.mark.parametrize("arch,opt", CKPT_CASES)
def test_jax_trainer_moe_checkpoint_restores_into_port_trainer(
        moe_ref, adafactor_ckpt, arch, opt):
    moe = moe_ref(arch)
    d, jstate, step = _ckpt_case(moe, adafactor_ckpt, opt)
    st = Trainer(_run(moe["tcfg"], opt=opt), device="cpu",
                 ckpt_dir=d).restore()
    assert st.step == step and st.opt_state.step == step
    _same_tree(jstate.params, st.params)
    if opt == "adafactor":
        assert jstate.opt_state.mu is None and st.opt_state.mu is None
    else:
        _same_tree(jstate.opt_state.mu, st.opt_state.mu)
    _same_tree(jstate.opt_state.nu, st.opt_state.nu)
    keys = [k for k, _ in CKPT.flatten({"params": st.params,
                                        "opt": st.opt_state})]
    assert "['params']['layers']['moe']['wg']" in keys
    if moe["tcfg"].moe.dense_layers:
        assert "['params']['dense_prefix'][0]['mlp']['wg']" in keys


@pytest.mark.parametrize("arch,opt", CKPT_CASES)
def test_port_trainer_moe_checkpoint_restores_into_jax(
        moe_ref, adafactor_ckpt, arch, opt, tmp_path):
    """The port continues the reference's run one step and checkpoints;
    the reference's ``checkpoint.restore`` reads every leaf back
    bitwise."""
    moe = moe_ref(arch)
    d, jstate, step = _ckpt_case(moe, adafactor_ckpt, opt)
    run = _run(moe["tcfg"], opt=opt)
    tr = Trainer(run, device="cpu", ckpt_dir=str(tmp_path))
    tr.train(step + 1, state=Trainer(run, device="cpu", ckpt_dir=d).restore())
    like = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                        {"params": jstate.params, "opt": jstate.opt_state})
    got, at, _ = JCKPT.restore(str(tmp_path), like)
    assert at == step + 1 and int(got["opt"].step) == step + 1
    mine = tr.restore()
    _same_tree(got["params"], mine.params)
    _same_tree(got["opt"].nu, mine.opt_state.nu)
    if opt == "adam":
        _same_tree(got["opt"].mu, mine.opt_state.mu)


def test_cli_trains_reduced_moe_with_adafactor(capsys):
    log = TCLI.main(["--arch", ARCHS[0], "--reduced", "--device", "cpu",
                     "--steps", "2", "--batch", "2", "--seq", "16",
                     "--optimizer", "adafactor"])
    assert [m["step"] for m in log] == [1, 2]
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert lines == log
    assert all(np.isfinite(m["loss"]) and m["aux"] > 0 for m in log)
