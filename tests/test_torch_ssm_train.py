"""SSM and hybrid training of the port (mamba2-130m, hymba-1.5b) against
the JAX package.

  * the SSD block's gradient at full width (mamba2's H 24, P 64, N 128 and
    hymba's H 50, P 64, N 16; one layer, B = 1, T = 512: two chunks of
    256, and T = 300: a padded last chunk): the port's ``ssd_forward``
    backward is finite and within REL_TOL of ``jax.grad`` of the
    reference's sequential ``ssd_reference`` on every leaf.  The
    reference's own ``ssd_forward`` cannot be the oracle there: its
    gradient is NaN (``exp`` of the masked upper triangle overflows and
    ``where`` sends 0 x inf back; ROADMAP.md §3), which a test pins;
  * reduced mamba2, the whole model: the first step's gradients of
    ``steps.loss_fn`` against ``jax.value_and_grad`` of the reference's
    ``loss_fn`` (``xent_chunk`` 0 and 8), and a 5-step loss curve of the
    port's ``Trainer`` against the reference's jitted train step (one jit
    with the first-step gradient, so XLA compiles them together);
  * reduced hymba, layer by layer: each layer's input and output
    cotangent recorded in one jitted pass of the reference's layers, then
    ``jax.vjp`` of its ``_dense_layer`` (attention beside ``_mixer_part``'s
    SSD block) against the port's ``_dense_layer`` on the same input and
    cotangent;
  * reduced hymba, the whole model: first-step gradients (blocked
    attention at 3 layers; qchunked at 4, where ``can_qchunk`` allows)
    and the 5-step curve;
  * within the port, bitwise: remat on equals off, a hymba preempt /
    resume through ``Slice.train`` equals the uninterrupted run;
  * format-v2 checkpoints (params and Adam's state) written by the
    reference's ``Trainer`` into the port's, and back, every leaf
    bitwise; ``Dataset`` batches bitwise the reference's; the train CLI.

Weights: the reference's ``init_params`` from ``PRNGKey(0)`` (f32), handed
over through numpy.  Tolerances:
  * a gradient leaf within REL_TOL = 2^-5 of the reference's largest |g|
    on that leaf (the logits bar of ROADMAP.md), but for the hybrid's
    whole-model ``ssm.dt_bias`` and ``ssm.A_log``: each layer's within
    REL_TOL of the largest |g| of that layer's ``ssm`` subtree.  Those two
    are cancelling sums over every position, 30-100x smaller than the
    block's other leaves, and past the first layer they carry the
    hybrid's ~1% bf16 drift (the reference differs from itself by 1.6%
    on ``dt_bias`` between jit and eager); the layer-by-layer test holds
    them, and every leaf, at the full per-leaf bar;
  * losses: 1e-3 + 2^-7 |loss| at every step; checkpoints exact.
"""
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
from repro.models import layers as JL
from repro.models import ssm as JSSM
from repro.models import transformer as JTF
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
from repro_torch.data.synthetic import Dataset as TDataset
from repro_torch.launch import steps as TSTEPS
from repro_torch.launch import train as TCLI
from repro_torch.models import api as TAPI
from repro_torch.models import ssm as TSSM
from repro_torch.models import transformer as TTF
from repro_torch.optim import adam as TOPT
from repro_torch.train.trainer import Trainer, TrainerState
# one SSD block's f32 weights from numpy: the reference's shapes, init
# scales and decay leaves (A up to 16, dt up to 0.1: at full width the
# upper triangle of a 256-chunk passes exp's range), the zero / one leaves
# perturbed so that each one counts
from test_torch_ssm import _np_params as _ssd_params

ARCHS = ("mamba2-130m", "hymba-1.5b")
REL_TOL = 2.0 ** -5
B, T = 2, 24
OCFG = dict(lr=1e-3, warmup_steps=2)
CURVE_STEPS = 5
# the hybrid's two per-head decay leaves, held to their layer's ssm subtree
DECAY_LEAVES = ("dt_bias", "A_log")


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


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _share(got, want) -> float:
    """max |got - want| over REL_TOL x max |want|."""
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.isfinite(got).all()
    return float(np.abs(got - want).max()
                 / (REL_TOL * max(np.abs(want).max(), 1e-30)))


def _named(tree, prefix=""):
    """(path, leaf) in JAX's flattening order (dict keys sorted), the order
    of ``TOPT.leaves`` and ``jax.tree.leaves``."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _named(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree)
                for kv in _named(v, f"{prefix}/{i}")]
    return [(prefix, tree)]


# ---------------------------------------------------------------------------
# The SSD block's gradient at full width
# ---------------------------------------------------------------------------

def _ssd_inputs(cfg, T_, seed=1):
    """u ~ N(0, 1) (rounded to bf16 on both sides) and the weights ``w`` of
    the scalar sum(out * w) that both gradients are taken of."""
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((1, T_, cfg.d_model)).astype(np.float32)
    w = rng.standard_normal((1, T_, cfg.d_model)).astype(np.float32)
    return u, w


def _jax_ssd_grad(cfg, fn, p, u, w):
    """``jax.grad`` of sum(fn(cfg, p, u)[0] * w) with respect to the params
    and u (bf16), jitted."""
    def loss(jp, ju):
        return (fn(cfg, jp, ju)[0].astype(jnp.float32) * w).sum()
    return jax.jit(jax.grad(loss, argnums=(0, 1)))(
        {k: jnp.asarray(v) for k, v in p.items()},
        jnp.asarray(u, jnp.bfloat16))


@pytest.mark.parametrize("T_", [512, 300])
@pytest.mark.parametrize("arch", ARCHS)
def test_ssd_forward_gradient_at_full_width_matches_jax_reference(arch, T_):
    """The port's chunked ``ssd_forward`` backward at full SSD width (two
    chunks of 256, or a padded last chunk) against ``jax.grad`` of the
    reference's f32 sequential ``ssd_reference``: every leaf (and u's
    gradient) finite and within REL_TOL of its largest |g|."""
    jcfg, tcfg = JREG.get_config(arch), TREG.get_config(arch)
    p = _ssd_params(tcfg)
    u, w = _ssd_inputs(tcfg, T_)
    jg, jgu = _jax_ssd_grad(jcfg, JSSM.ssd_reference, p, u, w)
    tp = {k: torch.from_numpy(v).requires_grad_(True) for k, v in p.items()}
    tu = torch.from_numpy(u).bfloat16().requires_grad_(True)
    out, _, _ = TSSM.ssd_forward(tcfg, tp, tu)
    (out.float() * torch.from_numpy(w)).sum().backward()
    shares = {k: _share(tp[k].grad, jg[k]) for k in sorted(p)}
    shares["u"] = _share(tu.grad, jgu)
    worst = max(shares, key=shares.get)
    print(f"{arch} T={T_}: worst leaf {worst} at {shares[worst]:.3f} of "
          f"the bar")
    assert all(s <= 1.0 for s in shares.values()), shares


def test_reference_ssd_forward_gradient_is_nan_at_full_width():
    """The reference's fault, pinned (ROADMAP.md §3): ``jax.grad`` of its
    chunked ``ssd_forward`` at mamba2's full width is NaN on ``in_proj``,
    ``A_log`` and ``dt_bias`` (its ``where(tri, exp(seg), 0)`` overflows
    above the diagonal), while the port's, above, is finite."""
    jcfg, tcfg = JREG.get_config("mamba2-130m"), TREG.get_config(
        "mamba2-130m")
    p = _ssd_params(tcfg)
    u, w = _ssd_inputs(tcfg, 512)
    jg, _ = _jax_ssd_grad(jcfg, JSSM.ssd_forward, p, u, w)
    nan = {k for k, g in jg.items() if not np.isfinite(_f32(g)).all()}
    assert nan == {"in_proj", "A_log", "dt_bias"}


# ---------------------------------------------------------------------------
# Reduced models against the reference's loss_fn and train step
# ---------------------------------------------------------------------------

# name -> (arch, layers): hymba4's 4 layers tile its local/global pattern
# (global_every 2), so its attention can run qchunked
MODELS = {"mamba2": ("mamba2-130m", 3), "hymba": ("hymba-1.5b", 3),
          "hymba4": ("hymba-1.5b", 4)}
# (model, xent_chunk, attn_impl) of the first-step gradient tests; the
# loss curves (and the checkpoints) run the first of each family's
COMBOS = [("mamba2", 0, "blocked"), ("mamba2", 8, "blocked"),
          ("hymba", 0, "blocked")]
CURVES = [("mamba2", 0, "blocked"), ("hymba", 0, "blocked")]


def _configs(name):
    arch, layers = MODELS[name]
    return (JREG.get_reduced(arch).replace(num_layers=layers),
            TREG.get_reduced(arch).replace(num_layers=layers))


def _jbatch(jcfg, step, seq=T, batch=B):
    return JDataset(jcfg, JShape("t", "train", seq, batch)).batch(step)


def _tbatch(nb):
    return {k: torch.from_numpy(v) for k, v in nb.items()}


def _run(tcfg, *, remat="none", xent_chunk=0, impl="blocked"):
    return TRun(model=tcfg, shape=TShape("t", "train", T, B),
                parallel=TPar(remat=remat, xent_chunk=xent_chunk,
                              attn_impl=impl),
                optimizer=TOpt(**OCFG))


def _jrun(jcfg, xent_chunk=0, impl="blocked"):
    return JRun(model=jcfg, shape=JShape("t", "train", T, B),
                parallel=JPar(remat="none", xent_chunk=xent_chunk,
                              attn_impl=impl),
                optimizer=JOpt(**OCFG))


@pytest.fixture(scope="module")
def model():
    """name -> random f32 params from seed 0 in the reference's layout
    (numpy; drawn by the port's init, whose formulas are the reference's:
    JAX's own init takes seconds a model here) and both configs, each
    built once."""
    cache = {}

    def get(name):
        if name not in cache:
            jcfg, tcfg = _configs(name)
            npp = TOPT.tree_map(lambda t: t.numpy(), TAPI.init_params(
                tcfg, seed=0, device="cpu", dtype=torch.float32))
            cache[name] = dict(name=name, jcfg=jcfg, tcfg=tcfg, npp=npp)
        return cache[name]

    return get


@pytest.fixture(scope="module")
def jref(model, tmp_path_factory):
    """(model, xent_chunk, impl) -> the reference's first-step loss, metrics
    and gradients (``jax.value_and_grad`` of ``loss_fn`` on batch 0, jitted).
    For a combination of CURVES also its 5-step loss curve, from one
    jitted function that runs its train step at one microbatch (what
    ``make_train_step`` runs: that gradient, then ``OPT.apply``), and the
    state after it checkpointed at step 5 by the reference's ``Trainer``."""
    cache = {}

    def get(name, xent_chunk, impl):
        key = (name, xent_chunk, impl)
        if key in cache:
            return cache[key]
        m = model(name)
        jcfg = m["jcfg"]
        run = _jrun(jcfg, xent_chunk, impl)
        curves = key in CURVES

        def vg(p, nb):
            return jax.value_and_grad(
                lambda q: JSTEPS.loss_fn(jcfg, q, nb, LOCAL,
                                         xent_chunk=xent_chunk,
                                         attn_impl=impl), has_aux=True)(p)

        jp = jax.tree.map(jnp.asarray, m["npp"])
        if not curves:
            cache[key] = dict(first=jax.jit(vg)(jp, _jbatch(jcfg, 0)))
            return cache[key]

        def step(p, o, nb):
            # make_train_step's body at one microbatch (its payload metrics
            # aside): the loss and gradient of loss_fn, then OPT.apply
            res = vg(p, nb)
            return res, JOPT.apply(run.optimizer, p, res[1], o)

        fn = jax.jit(step)
        jo = JOPT.init(run.optimizer, jp)
        curve = []
        for s in range(CURVE_STEPS):
            vg_s, (jp, jo, _) = fn(jp, jo, _jbatch(jcfg, s))
            if s == 0:
                out = dict(first=vg_s)
            curve.append(float(vg_s[0][0]))
        d = str(tmp_path_factory.mktemp(f"{name}_ckpt"))
        JTrainer(run, make_local_mesh(), ckpt_dir=d).save(
            JTrainerState(jp, jo, CURVE_STEPS))
        out.update(curve=curve, ckpt=d,
                   jstate=JTrainerState(jp, jo, CURVE_STEPS))
        cache[key] = out
        return out

    return get


def _grad_shares(tcfg, names, got, want):
    """Each leaf's share of its bar: max |got - want| over REL_TOL x that
    leaf's largest |want|; for the hybrid's ``ssm.dt_bias`` / ``ssm.A_log``
    each layer's over REL_TOL x the largest |want| of that layer's ``ssm``
    subtree.  Returns (shares, the per-leaf shares of every leaf)."""
    own = {n: _share(g, w) for n, g, w in zip(names, got, want)}
    if tcfg.family != "hybrid":
        return own, own
    ssm = [i for i, n in enumerate(names) if n.startswith("/layers/ssm/")]
    layer_max = np.max([np.abs(_f32(want[i])).reshape(
        tcfg.num_layers, -1).max(axis=1) for i in ssm], axis=0)
    shares = dict(own)
    for i in ssm:
        if names[i].rsplit("/", 1)[1] in DECAY_LEAVES:
            err = np.abs(_f32(got[i]) - _f32(want[i])).reshape(
                tcfg.num_layers, -1).max(axis=1)
            shares[names[i]] = float((err / (REL_TOL * layer_max)).max())
    return shares, own


@pytest.mark.parametrize("name,xent_chunk,impl", COMBOS)
def test_first_step_gradients_match_jax(model, jref, name, xent_chunk, impl):
    """``steps.value_and_grad`` (ce + 0.01 x aux, aux 0) against
    ``jax.value_and_grad`` of the reference's ``loss_fn`` on batch 0: the
    loss within the curve bar, every leaf within its bar (module
    docstring).  Prints the worst leaf on both measures."""
    m = model(name)
    tcfg = m["tcfg"]
    (jloss, jm), jg = jref(name, xent_chunk, impl)["first"]
    tp = interop.params_from_numpy(m["npp"])
    pcfg = TPar(remat="none", xent_chunk=xent_chunk, attn_impl=impl)
    metrics, tg = TSTEPS.value_and_grad(tcfg, pcfg, tp,
                                        _tbatch(_jbatch(m["jcfg"], 0)))
    assert set(metrics) == set(jm) == {"loss", "aux"}
    assert float(metrics["aux"]) == float(jm["aux"]) == 0.0
    assert _loss_close(float(metrics["loss"]), float(jloss))
    names = [n for n, _ in _named(m["npp"])]
    jl = jax.tree.leaves(jg)
    assert len(tg) == len(jl) == len(names)
    assert all(g.dtype == torch.float32 for g in tg)
    shares, own = _grad_shares(tcfg, names, tg, jl)
    worst = max(shares, key=shares.get)
    worst_own = max(own, key=own.get)
    print(f"{name} xent_chunk={xent_chunk} {impl}: worst {worst} at "
          f"{shares[worst]:.3f} of its bar; per leaf, {worst_own} at "
          f"{own[worst_own]:.3f}")
    assert all(s <= 1.0 for s in shares.values()), shares
    assert not any(p.requires_grad for p in TOPT.leaves(tp))


@pytest.mark.parametrize("name,xent_chunk,impl", CURVES)
def test_loss_curve_matches_jax_train_step(model, jref, name, xent_chunk,
                                           impl):
    """5 Adam steps from the same params on the same ``Dataset`` batches:
    the port's ``Trainer`` against the reference's jitted train step."""
    m = model(name)
    want = jref(name, xent_chunk, impl)["curve"]
    run = _run(m["tcfg"], xent_chunk=xent_chunk, impl=impl)
    tr = Trainer(run, device="cpu")
    tp = interop.params_from_numpy(m["npp"])
    state = tr.train(CURVE_STEPS, state=TrainerState(
        tp, TOPT.init(run.optimizer, tp), 0), log_every=1)
    got = [x["loss"] for x in tr.metrics_log]
    assert len(got) == CURVE_STEPS
    assert all(_loss_close(g, w) for g, w in zip(got, want)), (got, want)
    assert state.step == state.opt_state.step == CURVE_STEPS


# -- hymba, one layer at a time -------------------------------------------------

def _layer_params(tree, l):
    return jax.tree.map(lambda a: a[l], tree)


@pytest.fixture(scope="module")
def hymba_layers(model):
    """The reference's own first step taken apart by layer, in one jitted
    function: the reference's ``_dense_layer`` on each layer's sliced
    params through ``jax.vjp`` (the window traced, as in its scan), then
    its ``final_norm``, ``unembed`` and ``_xent``; backward from the loss,
    each layer's vjp takes its output's cotangent.  Returns, a layer, its
    input, that cotangent and the vjp's (param, input) gradients."""
    m = model("hymba")
    jcfg = m["jcfg"]
    nb = _jbatch(jcfg, 0)
    positions = jnp.broadcast_to(jnp.arange(T, dtype=jnp.int32), (B, T))

    @jax.jit
    def layerwise(p, wins):
        x = JTF.embed_tokens(jcfg, p, nb["tokens"])
        xs, vjps = [], []
        for l in range(jcfg.num_layers):
            xs.append(x)
            x, vjp = jax.vjp(lambda q, y, l=l: JTF._dense_layer(
                jcfg, q, y, positions, wins[l], LOCAL)[0],
                _layer_params(p["layers"], l), x)
            vjps.append(vjp)
        _, head = jax.vjp(lambda y: JSTEPS._xent(JTF.unembed(
            jcfg, p, JL.apply_norm(jcfg, p["final_norm"], y)),
            nb["labels"]), x)
        (ct,) = head(jnp.ones((), jnp.float32))
        out = [None] * jcfg.num_layers
        for l in reversed(range(jcfg.num_layers)):
            g_lp, g_x = vjps[l](ct)
            out[l] = dict(x=xs[l], ct=ct, g_lp=g_lp, g_x=g_x)
            ct = g_x
        return out

    wins = JTF.window_schedule(jcfg)
    recs = layerwise(jax.tree.map(jnp.asarray, m["npp"]), jnp.asarray(wins))
    return [dict(rec, win=int(w)) for rec, w in zip(recs, wins)]


@pytest.mark.parametrize("layer", range(3))
def test_hymba_layer_gradients_match_jax_vjp(model, hymba_layers, layer):
    """One hybrid layer (attention beside the SSD block, the alpha mix, the
    MLP) on the reference's own input and output cotangent of that layer:
    the port's ``_dense_layer`` output, every param leaf's gradient (the
    SSD block's ``dt_bias`` and ``A_log`` included) and the input's
    gradient within REL_TOL of ``jax.vjp``'s, each leaf of its own largest
    |g|.  Holds the layer's arithmetic without the drift of the layers
    before it."""
    m = model("hymba")
    rec = hymba_layers[layer]
    lp = interop.params_from_numpy(TTF._layer(m["npp"]["layers"], layer))
    views = TOPT.tree_map(lambda t: t.requires_grad_(True), lp)
    x = torch.from_numpy(_f32(rec["x"])).bfloat16().requires_grad_(True)
    win = TTF._windows(m["tcfg"])[layer]
    assert (win is None) == (rec["win"] >= TTF.GLOBAL_WINDOW)
    positions = torch.arange(T).expand(B, T)
    out, aux = TTF._dense_layer(m["tcfg"], views, x, positions, win)
    assert aux is None and out.dtype == torch.bfloat16
    out.backward(torch.from_numpy(_f32(rec["ct"])).bfloat16())
    want_lp, want_x = rec["g_lp"], rec["g_x"]
    names = [n for n, _ in _named(views)]
    shares = {n: _share(v.grad, g) for n, v, g in
              zip(names, TOPT.leaves(views), jax.tree.leaves(want_lp))}
    shares["x"] = _share(x.grad, want_x)
    worst = max(shares, key=shares.get)
    print(f"hymba layer {layer}: worst {worst} at {shares[worst]:.3f} of "
          f"its bar")
    assert len(shares) == len(jax.tree.leaves(want_lp)) + 1
    assert all(s <= 1.0 for s in shares.values()), shares


# ---------------------------------------------------------------------------
# Within the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["mamba2", "hymba"])
def test_remat_on_equals_off_bitwise(model, name):
    m = model(name)
    batch = _tbatch(_jbatch(m["jcfg"], 0))
    out = {}
    for remat in ("none", "block"):
        tp = interop.params_from_numpy(m["npp"])
        out[remat] = TSTEPS.value_and_grad(
            m["tcfg"], TPar(remat=remat, xent_chunk=8), tp, batch)
    (m0, g0), (m1, g1) = out["none"], out["block"]
    assert torch.equal(m0["loss"], m1["loss"])
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))


@pytest.mark.parametrize("arch", ARCHS)
def test_dataset_batches_are_the_reference_bitwise(arch):
    shape = ("t", "train", T, B)
    for step in (0, 7):
        want = JDataset(JREG.get_reduced(arch), JShape(*shape)).batch(step)
        got = TDataset(TREG.get_reduced(arch), TShape(*shape)).batch(step)
        assert got.keys() == want.keys() == {"tokens", "labels"}
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


def test_hymba_preempt_and_resume_through_slice_train_is_bitwise(
        model, tmp_path):
    """Remat, chunked cross-entropy, two microbatches a step: preempted
    at step 3 through ``Slice.request_preempt``, resumed on a slice of
    another shape; the loss curve and the final params are bitwise the
    uninterrupted ``Slice.train`` run's, and the params are f32."""
    run = _run(model("hymba")["tcfg"], remat="block", xent_chunk=8)
    sc = Supercomputer(device="cpu")
    clean = sc.allocate((8, 8, 8)).train(run, 5, accum_steps=2,
                                         log_every=1)
    want = [x["loss"] for x in clean.metrics_log if "loss" in x]
    assert len(want) == 5 and all(np.isfinite(want))
    first = sc.allocate((8, 8, 8))
    sess = first.train(run, ckpt_dir=str(tmp_path), accum_steps=2)
    sess.run(3, log_every=1)
    first.request_preempt()
    sess.run(5, log_every=1)
    assert sess.preempted and sess.state.step == 3
    first.free()
    resumed = sc.allocate((4, 8, 8)).train(run, 5, ckpt_dir=str(tmp_path),
                                           accum_steps=2, log_every=1)
    got = ([x["loss"] for x in sess.metrics_log if "loss" in x]
           + [x["loss"] for x in resumed.metrics_log if "loss" in x])
    assert got == want
    assert all(p.dtype == torch.float32 for p in TOPT.leaves(clean.params))
    assert all(torch.equal(a, b) for a, b in
               zip(TOPT.leaves(resumed.params), TOPT.leaves(clean.params)))


# -- checkpoints, both ways -------------------------------------------------------

def _same_tree(jtree, ttree):
    jl, tl = jax.tree.leaves(jtree), TOPT.leaves(ttree)
    assert len(jl) == len(tl) > 0
    for a, b in zip(jl, tl):
        a, b = np.asarray(a), b.numpy()
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["mamba2", "hymba"])
def test_jax_trainer_checkpoint_restores_into_port_trainer(model, jref,
                                                           name):
    """The reference's ``Trainer`` checkpoint of the state after its 5-step
    curve (params and Adam's ``mu``, ``nu``) restores into the port's
    ``Trainer`` bit for bit, under the same keys."""
    m = model(name)
    ref = jref(name, 0, "blocked")
    st = Trainer(_run(m["tcfg"]), device="cpu", ckpt_dir=ref["ckpt"]).restore()
    assert st.step == st.opt_state.step == CURVE_STEPS
    _same_tree(ref["jstate"].params, st.params)
    _same_tree(ref["jstate"].opt_state.mu, st.opt_state.mu)
    _same_tree(ref["jstate"].opt_state.nu, st.opt_state.nu)


@pytest.mark.parametrize("name", ["mamba2", "hymba"])
def test_port_trainer_checkpoint_restores_into_jax(model, jref, name,
                                                   tmp_path):
    """The port continues the reference's run one step and checkpoints;
    the reference's ``checkpoint.restore`` reads every leaf back bitwise."""
    m = model(name)
    ref = jref(name, 0, "blocked")
    run = _run(m["tcfg"])
    tr = Trainer(run, device="cpu", ckpt_dir=str(tmp_path))
    tr.train(CURVE_STEPS + 1,
             state=Trainer(run, device="cpu", ckpt_dir=ref["ckpt"]).restore())
    jstate = ref["jstate"]
    like = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                        {"params": jstate.params, "opt": jstate.opt_state})
    got, at, _ = JCKPT.restore(str(tmp_path), like)
    assert at == CURVE_STEPS + 1 and int(got["opt"].step) == CURVE_STEPS + 1
    mine = tr.restore()
    _same_tree(got["params"], mine.params)
    _same_tree(got["opt"].mu, mine.opt_state.mu)
    _same_tree(got["opt"].nu, mine.opt_state.nu)


@pytest.mark.parametrize("arch", ARCHS)
def test_cli_trains_reduced_on_cpu(arch, capsys):
    log = TCLI.main(["--arch", arch, "--reduced", "--device", "cpu",
                     "--steps", "3", "--batch", "2", "--seq", "32"])
    assert [x["step"] for x in log] == [1, 2, 3]
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert lines == log
    assert all(np.isfinite(x["loss"]) and x["aux"] == 0.0 for x in log)
