"""The dense variants qwen2-7b (qkv bias, GQA 7), mistral-nemo-12b
(d_model 5120 against 32 x 128 heads) and gemma2-9b (post norms, embedding
scale, attention and final softcaps, local/global windows, the tanh GELU
GLU, d_model 3584 against 16 x 256 heads) served by the port, against the
JAX package, at reduced size, and once as reduced gemma2 with gemma2's own
head_dim of 256.

Same weights on both sides: JAX's ``init_params`` with its zero leaves
(the qkv biases and the rmsnorm scales, the post norms included)
perturbed so they count and gemma2's tied embedding shrunk, handed over
through numpy
(``repro_torch.interop``).  Same prompts.  The JAX side is jitted
(``api.prefill``, ``decode_step_paged``, ``transformer.forward``, and its
``ServeEngine``'s own programs).  Every prompt is longer than gemma2's
reduced window of 16 (engine prompts are left-padded to 24), so its local
layers mask at prefill and at decode.

Tolerance.  Logits agree within LOGIT_TOL = 2^-5 * max|logit| (8 bf16 ulps
at the largest), as the other serving slices': the port's prefill
attention keeps f32 where JAX's blocked attention rounds q*scale, k and p
to bf16, and the two frameworks round bf16 matmul outputs at slightly
different places.  Greedy streams match token for token, except where
JAX's top-2 logit margin (teacher-forced over the engine's left-padded
prompt) is under LOGIT_TOL; the test reports the first such position.
Port-internal properties (chunk invariance, ``Slice.serve`` against the
engine) are bitwise.
"""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as JREG
from repro.models import api as JAPI
from repro.models import transformer as JTF
from repro.serve.engine import ServeEngine as JEngine
from repro.serve.engine import SliceSpec as JSpec
from repro_torch import interop
from repro_torch.cluster import Supercomputer
from repro_torch.configs import registry as TREG
from repro_torch.launch import serve as TSERVE
from repro_torch.models import api as TAPI
from repro_torch.models import transformer as TTF
from repro_torch.serve.engine import ServeEngine as TEngine
from repro_torch.serve.engine import SliceSpec as TSpec

LOGIT_REL_TOL = 2.0 ** -5
ARCHS = ("qwen2-7b", "mistral-nemo-12b", "gemma2-9b")
# name -> (arch, head_dim of the reduced config, or None for its own)
MODELS = {"qwen2": ("qwen2-7b", None), "nemo": ("mistral-nemo-12b", None),
          "gemma2": ("gemma2-9b", None), "gemma2_d256": ("gemma2-9b", 256)}
SPEC = dict(slots=2, max_len=48, prompt_len=24, chunk=4)
# 3 requests over 2 slots: two admission waves; every prompt is longer
# than gemma2's reduced window of 16
PROMPT_LENS = (20, 24, 18)
BUDGETS = (10, 6, 8)
TIED_EMBED_SCALE = 0.05


def _tol(x: np.ndarray) -> float:
    return LOGIT_REL_TOL * float(np.abs(x).max())


def _with_head_dim(cfg, head_dim):
    if head_dim is None:
        return cfg
    return cfg.replace(attention=dataclasses.replace(
        cfg.attention, head_dim=head_dim, attn_scale=head_dim ** -0.5))


def _configs(name):
    arch, head_dim = MODELS[name]
    return (_with_head_dim(JREG.get_reduced(arch), head_dim),
            _with_head_dim(TREG.get_reduced(arch), head_dim))


def _np_weights(jcfg):
    """JAX's init, with the biases and norm scales (zeros there) drawn
    from N(0, 0.1^2).  A tied embedding (gemma2) is shrunk by
    TIED_EMBED_SCALE so the layers, not the input token, decide the next
    token: at JAX's N(0, 1) init, times gemma2's sqrt(d_model), every
    greedy stream repeats its last prompt token."""
    p = jax.tree.map(np.asarray, jax.jit(JAPI.init_params, static_argnums=0)(
        jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)

    def perturb(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                perturb(v)
            elif k in ("bq", "bk", "bv", "w"):
                tree[k] = (0.1 * rng.standard_normal(v.shape)).astype(
                    np.float32)
    perturb(p)
    if jcfg.tie_embeddings:
        p["embed"] = p["embed"] * np.float32(TIED_EMBED_SCALE)
    return p


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The reduced models' ops are tiny: one intra-op thread runs them
    fastest, and leaves the other test workers their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=list(MODELS))
def model(request):
    jcfg, tcfg = _configs(request.param)
    p = _np_weights(jcfg)
    return dict(name=request.param, jcfg=jcfg, tcfg=tcfg, np=p,
                jp=jax.tree.map(jnp.asarray, p),
                tp=interop.params_from_numpy(p))


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.default_rng(0)
    return [rng.integers(0, 512, size=n).astype(np.int32)
            for n in PROMPT_LENS]


def _serve(engine, prompts):
    reqs = [engine.submit(p, max_new_tokens=m)
            for p, m in zip(prompts, BUDGETS)]
    stats = engine.run()
    assert stats["requests_done"] == len(prompts)
    return [list(r.out_tokens) for r in reqs]


@pytest.fixture(scope="module")
def jax_streams(model, prompts):
    return _serve(JEngine(model["jcfg"], model["jp"], JSpec(**SPEC)), prompts)


@pytest.fixture(scope="module")
def port_streams(model, prompts):
    return _serve(TEngine(model["tcfg"], model["tp"], TSpec(**SPEC),
                          device="cpu"), prompts)


_jforward = jax.jit(lambda cfg, p, t: JTF.forward(cfg, p, {"tokens": t})[0],
                    static_argnums=0)
_jprefill = jax.jit(JAPI.prefill, static_argnums=0, static_argnames="max_len")
_jstep = jax.jit(JTF.decode_step_paged, static_argnums=0)


# ---------------------------------------------------------------------------
# Configs, trees, windows
# ---------------------------------------------------------------------------

def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("getter", ["get_config", "get_reduced"])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_copy_matches_reference(arch, getter):
    """The registry holds the three archs under the reference's names, and
    every field of each copy (``ModelConfig`` and its ``AttentionConfig``)
    equals the reference's."""
    assert arch in TREG.ARCHS
    t, j = getattr(TREG, getter)(arch), getattr(JREG, getter)(arch)
    assert t.name == arch and t.family == "dense"
    for f in dataclasses.fields(t):
        if f.name != "attention":
            assert getattr(t, f.name) == getattr(j, f.name), f.name
    assert dataclasses.asdict(t.attention) == dataclasses.asdict(j.attention)


@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_tree_matches_reference_shapes(arch):
    """Every leaf of the port's full-width tree (meta tensors, bf16) has the
    shape of ``jax.eval_shape`` of the reference's ``init_params``: qwen2's
    biases, gemma2's post norms and its tied 256000-row embedding (no
    ``head``), and ``d_model != num_heads * head_dim`` in ``wo``."""
    jcfg, tcfg = JREG.get_config(arch), TREG.get_config(arch)
    want = {k: tuple(v.shape) for k, v in _leaves(jax.eval_shape(
        lambda k: JAPI.init_params(jcfg, k), jax.random.PRNGKey(0))).items()}
    tree = TAPI.param_shapes(tcfg)
    got = _leaves(tree)
    assert {k: tuple(v.shape) for k, v in got.items()} == want
    assert all(v.dtype == torch.bfloat16 for v in got.values())
    a = tcfg.attention
    assert got["/layers/attn/wo"].shape == (
        tcfg.num_layers, a.num_heads * a.head_dim, tcfg.d_model)
    assert ("/layers/attn/bq" in got) == a.qkv_bias == (arch == "qwen2-7b")
    assert ("/layers/post_ln1/w" in got) == (arch == "gemma2-9b")
    assert ("/head" not in got) == tcfg.tie_embeddings
    if arch == "gemma2-9b":
        assert got["/embed"].shape == (256000, 3584)


def test_gemma2_window_schedule_follows_the_reference():
    """Every second layer global (layers 1, 3, ..., 41 of 42 at full width;
    1 and 3 of the reduced 4), the others at the window (4096; reduced
    16), as the reference's ``window_schedule``."""
    for getter, n, w in (("get_config", 42, 4096), ("get_reduced", 4, 16)):
        tcfg = getattr(TREG, getter)("gemma2-9b")
        jcfg = getattr(JREG, getter)("gemma2-9b")
        np.testing.assert_array_equal(TTF.window_schedule(tcfg),
                                      JTF.window_schedule(jcfg))
        assert TTF._windows(tcfg) == [None if l % 2 else w for l in range(n)]
        assert TTF.attn_group_size(tcfg) == JTF.attn_group_size(jcfg) == 2
    for arch in ("qwen2-7b", "mistral-nemo-12b"):
        assert set(TTF._windows(TREG.get_config(arch))) == {None}


def test_interop_carries_every_leaf(model):
    """The JAX tree's leaves (biases and post norms among them) come over
    with their names, shapes, dtypes and values."""
    j, t = _leaves(model["np"]), _leaves(model["tp"])
    assert j.keys() == t.keys()
    for path, a in j.items():
        b = t[path]
        assert tuple(b.shape) == a.shape and b.dtype == torch.float32, path
        np.testing.assert_array_equal(b.numpy(), a, err_msg=path)
    lp = model["tp"]["layers"]
    a = model["tcfg"].attention
    if a.qkv_bias:
        assert lp["attn"]["bk"].shape == (3, a.num_kv_heads, a.head_dim)
    if model["tcfg"].post_norm:
        assert {"post_ln1", "post_ln2"} <= lp.keys()


# ---------------------------------------------------------------------------
# Against JAX: model paths
# ---------------------------------------------------------------------------

def test_prefill_logits_match_jax(model):
    """A prefill of 24 tokens (past gemma2's reduced window) into a cache of
    40: last-position logits within LOGIT_TOL, the KV rows written and
    the rest zero."""
    toks = np.random.default_rng(1).integers(0, 512, size=(3, 24))
    jl, jc = _jprefill(model["jcfg"], model["jp"],
                       {"tokens": jnp.asarray(toks, jnp.int32)}, max_len=40)
    tl, tc = TAPI.prefill(model["tcfg"], model["tp"],
                          {"tokens": torch.from_numpy(toks)}, max_len=40)
    jl = np.asarray(jl)
    assert tl.dtype == torch.float32 and tuple(tl.shape) == jl.shape
    np.testing.assert_allclose(tl.numpy(), jl, atol=_tol(jl), rtol=0)
    a = model["tcfg"].attention
    assert tuple(tc.k.shape) == (model["tcfg"].num_layers, 3, 40,
                                 a.num_kv_heads, a.head_dim)
    assert int(tc.pos) == 24 and not tc.k[:, :, 24:].any()
    np.testing.assert_allclose(tc.k.float().numpy(),
                               np.asarray(jc.k.astype(jnp.float32)),
                               atol=_tol(np.asarray(jc.k, np.float32)),
                               rtol=0)


def test_decode_steps_match_jax_teacher_forced(model):
    """16 decode steps of random input tokens after that prefill, one lane
    frozen from step 6: the active lanes' logits within LOGIT_TOL of
    JAX's at every step, the lengths equal."""
    jcfg, tcfg, jp, tp = model["jcfg"], model["tcfg"], model["jp"], model["tp"]
    rng = np.random.default_rng(2)
    toks = rng.integers(0, 512, size=(3, 24))
    _, jc = _jprefill(jcfg, jp, {"tokens": jnp.asarray(toks, jnp.int32)},
                      max_len=40)
    _, tc = TAPI.prefill(tcfg, tp, {"tokens": torch.from_numpy(toks)},
                         max_len=40)
    lens = np.full((3,), 24, np.int32)
    jlens, tlens = jnp.asarray(lens), torch.from_numpy(lens)
    for step in range(16):
        active = np.array([True, step < 6, True])
        tk = rng.integers(0, 512, size=3)
        jl, jc, jlens = _jstep(jcfg, jp, jc, jnp.asarray(tk, jnp.int32),
                               jlens, jnp.asarray(active))
        tl, tc, tlens = TTF.decode_step_paged(
            tcfg, tp, tc, torch.from_numpy(tk), tlens,
            torch.from_numpy(active))
        jl = np.asarray(jl)
        np.testing.assert_allclose(tl.numpy()[active], jl[active],
                                   atol=_tol(jl[active]), rtol=0,
                                   err_msg=f"step {step}")
        np.testing.assert_array_equal(tlens.numpy(), np.asarray(jlens))


def test_attention_softcap_reaches_prefill_and_decode():
    """At reduced size gemma2's scores stay far below its attention softcap
    of 50, where tanh is the identity to within LOGIT_TOL; with the cap at
    0.3 it bites.  Prefill logits and 4 teacher-forced decode steps
    within LOGIT_TOL of JAX's at that cap, and away from the port's own
    logits at 50 (so the cap reaches the prefill and decode kernels' plain
    versions, not only the config)."""
    jcfg, tcfg = _configs("gemma2")
    p = _np_weights(jcfg)
    cap = lambda cfg, c: cfg.replace(attention=dataclasses.replace(
        cfg.attention, logit_softcap=c))
    jcfg, tlow, thigh = cap(jcfg, 0.3), cap(tcfg, 0.3), tcfg
    jp, tp = jax.tree.map(jnp.asarray, p), interop.params_from_numpy(p)
    rng = np.random.default_rng(5)
    toks = rng.integers(0, 512, size=(2, 24))
    jl, jc = _jprefill(jcfg, jp, {"tokens": jnp.asarray(toks, jnp.int32)},
                       max_len=32)
    runs = {c: TAPI.prefill(c, tp, {"tokens": torch.from_numpy(toks)},
                            max_len=32) for c in (tlow, thigh)}
    got = [(np.asarray(jl), runs[tlow][0].numpy(), runs[thigh][0].numpy())]
    jlens = jnp.full((2,), 24, jnp.int32)
    tlens = {c: torch.full((2,), 24, dtype=torch.int32) for c in runs}
    active = np.array([True, True])
    for _ in range(4):
        tk = rng.integers(0, 512, size=2)
        jl, jc, jlens = _jstep(jcfg, jp, jc, jnp.asarray(tk, jnp.int32),
                               jlens, jnp.asarray(active))
        step = [np.asarray(jl)]
        for c in (tlow, thigh):
            lg, cache, tlens[c] = TTF.decode_step_paged(
                c, tp, runs[c][1], torch.from_numpy(tk), tlens[c],
                torch.from_numpy(active))
            runs[c] = (lg, cache)
            step.append(lg.numpy())
        got.append(tuple(step))
    for s, (want, low, high) in enumerate(got):
        np.testing.assert_allclose(low, want, atol=_tol(want), rtol=0,
                                   err_msg=f"step {s}")
        assert np.abs(high - want).max() > _tol(want), f"step {s}"


def _jax_margin(model, prompt, out_tokens, i):
    """JAX top-2 logit margin (and tolerance) where token ``i`` of a stream
    was chosen, teacher-forced over the engine's left-padded prompt."""
    pad = np.zeros((SPEC["prompt_len"],), np.int32)
    seq = prompt[-SPEC["prompt_len"]:]
    pad[-len(seq):] = seq
    ctx = np.concatenate([pad, np.asarray(out_tokens[:i], np.int32)])
    logits = _jforward(model["jcfg"], model["jp"], jnp.asarray(ctx)[None])
    last = np.sort(np.asarray(logits[0, -1]))
    return float(last[-1] - last[-2]), _tol(last)


def test_engine_greedy_streams_match_jax(model, prompts, jax_streams,
                                         port_streams):
    """3 requests through each framework's ``ServeEngine``: every budget
    met with in-vocabulary ids, the streams token for token but at a near
    tie of JAX's logits (reported)."""
    for r, (js, ts) in enumerate(zip(jax_streams, port_streams)):
        assert len(ts) == len(js) == BUDGETS[r]
        assert all(0 <= t < model["tcfg"].vocab_size for t in ts)
        diff = [i for i, (a, b) in enumerate(zip(js, ts)) if a != b]
        if not diff:
            continue
        i = diff[0]
        margin, tol = _jax_margin(model, prompts[r], js, i)
        assert margin < tol, (
            f"request {r}: token {i} differs (jax {js[i]}, port {ts[i]}) "
            f"with a JAX top-2 margin {margin:.4f} >= tolerance {tol:.4f}")
        warnings.warn(f"{model['name']} request {r}: streams part at token "
                      f"{i}, a near tie (JAX top-2 margin {margin:.4f} < "
                      f"{tol:.4f})")


# ---------------------------------------------------------------------------
# Port-internal pins and entry points
# ---------------------------------------------------------------------------

def test_greedy_chunk_invariant_bitwise(model, prompts, port_streams):
    eng = TEngine(model["tcfg"], model["tp"], TSpec(**{**SPEC, "chunk": 1}),
                  device="cpu")
    assert _serve(eng, prompts) == port_streams


def test_slice_serve_equals_the_engine(model, prompts, port_streams):
    """``repro_torch.cluster``'s ``Slice.serve`` builds the same engine:
    the same streams, bit for bit."""
    sl = Supercomputer(device="cpu").allocate((4, 4, 4))
    session = sl.serve(model["tcfg"], model["tp"], TSpec(**SPEC))
    reqs = [session.submit(p, max_new_tokens=m)
            for p, m in zip(prompts, BUDGETS)]
    assert session.run()["requests_done"] == len(prompts)
    assert [list(r.out_tokens) for r in reqs] == port_streams
    sl.free()


@pytest.mark.parametrize("arch", ARCHS)
def test_cli_serves_reduced_on_cpu(arch, capsys):
    stats = TSERVE.main(["--arch", arch, "--reduced", "--device", "cpu",
                         "--requests", "3", "--slots", "2",
                         "--prompt-len", "24", "--max-len", "48",
                         "--new-tokens", "5"])
    assert stats["requests_done"] == 3 and stats["tokens"] == 15
    assert '"requests_done": 3' in capsys.readouterr().out
