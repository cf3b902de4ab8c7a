"""internvl2-2b (the VLM family: a dense GQA decoder after a prefix of
projected patch embeddings) served by the port through the fast path,
against the JAX package, at reduced size (3 layers, d 64, 4 heads over
2, a prefix of 8 patches of width 32).

Same weights on both sides: JAX's ``init_params`` with its rmsnorm
scales (zeros) perturbed so they count, handed over through numpy
(``repro_torch.interop``); ``vision_proj`` is JAX's draw.  The JAX side is
jitted (``transformer.forward``, ``api.prefill``, ``decode_step_paged``,
and its ``ServeEngine``'s own programs).

Tolerance.  Logits and caches agree within 2^-5 * max|value| (8 bf16 ulps
at the largest), the bar of the other serving slices: the port's prefill
attention (the flash kernel's plain version) keeps f32 probabilities where
JAX's blocked attention rounds q * scale, k and p to bf16.  Greedy streams
match token for token, except where JAX's top-2 logit margin
(teacher-forced over the engine's zero patches and left-padded prompt)
is under that bar; the test reports the first such position.
Port-internal properties (chunk invariance, ``Slice.serve``) are bitwise.
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
from repro_torch.configs.base import ShapeConfig as TShape
from repro_torch.launch import serve as TSERVE
from repro_torch.models import api as TAPI
from repro_torch.models import transformer as TTF
from repro_torch.serve.engine import ServeEngine as TEngine
from repro_torch.serve.engine import SliceSpec as TSpec

ARCH = "internvl2-2b"
LOGIT_REL_TOL = 2.0 ** -5
P = 8                                  # the reduced vision prefix
# max_len counts the prefix: 8 patch rows + a prompt of 16 + 16 new
SPEC = dict(slots=2, max_len=48, prompt_len=16, chunk=8)
# 5 requests over 2 slots: several admission waves
PROMPT_LENS = (12, 16, 9, 20, 5)
BUDGETS = (10, 6, 8, 12, 7)


def _tol(x) -> float:
    return LOGIT_REL_TOL * float(np.abs(np.asarray(x, np.float32)).max())


def _close(got: torch.Tensor, want, what: str):
    want = np.asarray(want, np.float32)
    assert tuple(got.shape) == want.shape, what
    np.testing.assert_allclose(got.float().numpy(), want, atol=_tol(want),
                               rtol=0, err_msg=what)


def _np_weights(jcfg):
    p = jax.tree.map(np.asarray, jax.jit(JAPI.init_params, static_argnums=0)(
        jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)

    def perturb(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                perturb(v)
            elif k == "w":
                tree[k] = (0.1 * rng.standard_normal(v.shape)).astype(
                    np.float32)
    perturb(p)
    return p


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The reduced model's ops are tiny: one intra-op thread runs them
    fastest, and leaves the other test workers their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = JREG.get_reduced(ARCH), TREG.get_reduced(ARCH)
    p = _np_weights(jcfg)
    return dict(jcfg=jcfg, tcfg=tcfg, np=p,
                jp=jax.tree.map(jnp.asarray, p),
                tp=interop.params_from_numpy(p))


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.default_rng(0)
    return [rng.integers(0, 512, size=n).astype(np.int32)
            for n in PROMPT_LENS]


def _batch(seed, B, T, vdim, zero_patches=False):
    """Numpy tokens (B, T) and patches (B, P, vdim): N(0, 1), or zeros."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 512, size=(B, T)).astype(np.int32)
    patches = rng.standard_normal((B, P, vdim)).astype(np.float32)
    if zero_patches:
        patches[:] = 0.0
    return toks, patches


def _jb(toks, patches):
    return {"tokens": jnp.asarray(toks), "patches": jnp.asarray(patches)}


def _tb(toks, patches):
    return {"tokens": torch.from_numpy(toks).long(),
            "patches": torch.from_numpy(patches)}


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


_jforward = jax.jit(lambda cfg, p, b: JTF.forward(cfg, p, b)[0],
                    static_argnums=0)
_jprefill = jax.jit(JAPI.prefill, static_argnums=0, static_argnames="max_len")
_jstep = jax.jit(JTF.decode_step_paged, static_argnums=0)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


# ---------------------------------------------------------------------------
# Config, tree
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("getter", ["get_config", "get_reduced"])
def test_config_copy_matches_reference(getter):
    """internvl2-2b is registered under the reference's name, and every
    field of its copy (the vision prefix and width among them) equals the
    reference's."""
    assert ARCH in TREG.ARCHS
    t, j = getattr(TREG, getter)(ARCH), getattr(JREG, getter)(ARCH)
    assert t.name == ARCH and t.family == "vlm"
    for f in dataclasses.fields(t):
        if f.name != "attention":
            assert getattr(t, f.name) == getattr(j, f.name), f.name
    assert dataclasses.asdict(t.attention) == dataclasses.asdict(j.attention)
    assert t.vision_prefix == j.vision_prefix > 0


def test_full_width_tree_matches_reference_shapes():
    """Every leaf of the port's full-width tree (meta tensors, bf16) has the
    shape of ``jax.eval_shape`` of the reference's ``init_params``:
    ``vision_proj`` (1024, 2048), GQA 16 over 8 heads of 128, an untied
    head; 1.89e9 parameters (3.78 GB in bf16)."""
    jcfg, tcfg = JREG.get_config(ARCH), TREG.get_config(ARCH)
    want = {k: tuple(v.shape) for k, v in _leaves(jax.eval_shape(
        lambda k: JAPI.init_params(jcfg, k), jax.random.PRNGKey(0))).items()}
    got = _leaves(TAPI.param_shapes(tcfg))
    assert {k: tuple(v.shape) for k, v in got.items()} == want
    assert all(v.dtype == torch.bfloat16 for v in got.values())
    assert got["/vision_proj"].shape == (1024, 2048)
    n = sum(v.numel() for v in got.values())
    assert n == 1_891_244_032


def test_interop_carries_every_leaf(model):
    j, t = _leaves(model["np"]), _leaves(model["tp"])
    assert j.keys() == t.keys() and "/vision_proj" in t
    for path, a in j.items():
        b = t[path]
        assert tuple(b.shape) == a.shape and b.dtype == torch.float32, path
        np.testing.assert_array_equal(b.numpy(), a, err_msg=path)


# ---------------------------------------------------------------------------
# Against JAX: model paths
# ---------------------------------------------------------------------------

def test_forward_logits_match_jax(model):
    """Teacher-forced logits over 8 random patches and 12 tokens (B 2): the
    P + T = 20 positions within the bar, and the patches count (zero
    patches move the text logits by more than the bar)."""
    vd = model["tcfg"].vision_dim
    toks, patches = _batch(3, 2, 12, vd)
    want = _jforward(model["jcfg"], model["jp"], _jb(toks, patches))
    got, aux = TAPI.forward(model["tcfg"], model["tp"], _tb(toks, patches))
    assert tuple(got.shape) == (2, P + 12, 512) and float(aux) == 0.0
    _close(got, want, "forward logits")
    zero, _ = TAPI.forward(model["tcfg"], model["tp"],
                           _tb(toks, np.zeros_like(patches)))
    assert (zero - got)[:, P:].abs().max() > _tol(want)


def test_prefill_and_decode_match_jax_teacher_forced(model):
    """A prefill of 8 patches + 12 tokens into a cache of 32 rows: logits
    and the P + T = 20 cached K/V rows within the bar (the rest zero,
    ``pos`` 20); then 8 decode steps of random tokens from ``seq_lens``
    20, one lane frozen from step 3: the active lanes' logits within the
    bar at every step, the lengths equal."""
    jcfg, tcfg, jp, tp = model["jcfg"], model["tcfg"], model["jp"], model["tp"]
    toks, patches = _batch(4, 3, 12, tcfg.vision_dim)
    jl, jc = _jprefill(jcfg, jp, _jb(toks, patches), max_len=32)
    tl, tc = TAPI.prefill(tcfg, tp, _tb(toks, patches), max_len=32)
    _close(tl, jl, "prefill logits")
    a = tcfg.attention
    assert tuple(tc.k.shape) == (3, 3, 32, a.num_kv_heads, a.head_dim)
    assert int(tc.pos) == P + 12 and not tc.k[:, :, P + 12:].any()
    _close(tc.k, jc.k, "cache k")
    _close(tc.v, jc.v, "cache v")
    rng = np.random.default_rng(5)
    lens = np.full((3,), P + 12, np.int32)
    jlens, tlens = jnp.asarray(lens), torch.from_numpy(lens)
    for step in range(8):
        active = np.array([True, step < 3, True])
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


# ---------------------------------------------------------------------------
# Against JAX: the engine
# ---------------------------------------------------------------------------

def _jax_margin(model, prompt, out_tokens, i):
    """JAX top-2 logit margin (and tolerance) where token ``i`` of a stream
    was chosen, teacher-forced over the engine's zero patches and
    left-padded prompt."""
    pad = np.zeros((SPEC["prompt_len"],), np.int32)
    seq = prompt[-SPEC["prompt_len"]:]
    pad[-len(seq):] = seq
    ctx = np.concatenate([pad, np.asarray(out_tokens[:i], np.int32)])[None]
    _, patches = _batch(0, 1, 1, model["tcfg"].vision_dim, zero_patches=True)
    logits = _jforward(model["jcfg"], model["jp"], _jb(ctx, patches))
    last = np.sort(np.asarray(logits[0, -1]))
    return float(last[-1] - last[-2]), _tol(last)


def test_engine_greedy_streams_match_jax(model, prompts, jax_streams,
                                         port_streams):
    """5 requests over 2 slots through each framework's fast-path
    ``ServeEngine`` (zero patches before every prompt): every budget met
    with in-vocabulary ids, the streams token for token but at a near tie
    of JAX's logits (reported)."""
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
        warnings.warn(f"internvl request {r}: streams part at token {i}, "
                      f"a near tie (JAX top-2 margin {margin:.4f} < "
                      f"{tol:.4f})")


def test_streams_move_between_tokens(jax_streams, port_streams):
    """The engine test's weights give streams that are not one repeated
    token (so a wrong token fed back or a wrong prefix offset in the decode
    lengths would show)."""
    for streams in (jax_streams, port_streams):
        assert sum(len(set(s)) > 1 for s in streams) >= 2


def test_seq_lens_after_admission_count_the_prefix(model, prompts):
    """An admission leaves each admitted slot's length at prompt_len +
    vision_prefix (the patch rows are cached), as the reference's."""
    eng = TEngine(model["tcfg"], model["tp"], TSpec(**SPEC), device="cpu")
    jeng = JEngine(model["jcfg"], model["jp"], JSpec(**SPEC))
    for e in (eng, jeng):
        for p in prompts[:2]:
            e.submit(p, max_new_tokens=4)
        e._admit()
    want = SPEC["prompt_len"] + P
    assert eng.seq_lens.tolist() == [want, want]
    assert np.asarray(jeng.seq_lens).tolist() == [want, want]


def test_greedy_chunk_invariant_bitwise(model, prompts, port_streams):
    eng = TEngine(model["tcfg"], model["tp"], TSpec(**{**SPEC, "chunk": 1}),
                  device="cpu")
    assert _serve(eng, prompts) == port_streams


def test_slice_serve_equals_the_engine(model, prompts, port_streams):
    sl = Supercomputer(device="cpu").allocate((4, 4, 4))
    session = sl.serve(model["tcfg"], model["tp"], TSpec(**SPEC))
    reqs = [session.submit(p, max_new_tokens=m)
            for p, m in zip(prompts, BUDGETS)]
    assert session.run()["requests_done"] == len(prompts)
    assert [list(r.out_tokens) for r in reqs] == port_streams
    sl.free()


def test_cli_serves_reduced_vlm_on_cpu(capsys):
    stats = TSERVE.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                         "--requests", "3", "--slots", "2",
                         "--new-tokens", "5"])
    assert stats["requests_done"] == 3 and stats["tokens"] == 15
    assert '"requests_done": 3' in capsys.readouterr().out


def test_cli_max_len_counts_the_prefix(capsys):
    """As the reference's CLI, ``--max-len`` is the whole cache, the patch
    rows included: one with no room for them and the prompt is refused
    by name, and the smallest that has room serves."""
    with pytest.raises(SystemExit):
        TSERVE.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                     "--prompt-len", "16", "--max-len", str(P + 15)])
    assert "patch rows" in capsys.readouterr().err
    stats = TSERVE.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                         "--requests", "2", "--slots", "2",
                         "--prompt-len", "16", "--max-len", str(P + 16),
                         "--new-tokens", "1"])
    assert stats["requests_done"] == 2 and stats["tokens"] == 2


def test_unported_vlm_paths_are_refused(model):
    """As the reference: the pooled cache is dense-only; int8 weights,
    batches and training of the VLM wait for item 11(i)."""
    cfg, tp = model["tcfg"], model["tp"]
    with pytest.raises(NotImplementedError, match="dense-transformer only"):
        TEngine(cfg, tp, TSpec(**SPEC, kv_block=16), device="cpu")
    with pytest.raises(NotImplementedError, match="dense-transformer only"):
        TAPI.init_kv_pool(cfg, 8, 16, device="cpu")
    with pytest.raises(NotImplementedError, match=r"item 11\(i\)"):
        TEngine(cfg, tp, TSpec(**SPEC, quant="int8"), device="cpu")
    with pytest.raises(NotImplementedError, match=r"item 11\(i\)"):
        TAPI.make_batch(cfg, TShape("x", "train", 16, 2), device="cpu")
    with pytest.raises(NotImplementedError, match="item 5"):
        TAPI.decode_step(cfg, tp, None, None)
    with pytest.raises(NotImplementedError, match="vision prefix"):
        TTF.init_params(cfg.replace(family="dense"), torch.Generator(),
                        device="cpu")
