"""whisper-small (the audio family: a transformer encoder over stub frame
embeddings and a causal decoder with cross-attention) served by the port
through the legacy full-batch engine path, against the JAX package, at
reduced size (2 + 2 layers, d 64, 4 heads of 16).

Same weights on both sides: JAX's ``init_params`` with its layernorm
scales and biases perturbed off their ones and zeros (so the biases count:
the engine's frames are zeros, and a zero frame leaves the encoder's first
layernorm only its bias) and its tied embedding shrunk by 0.05 (at JAX's
N(0, 1) init every greedy stream would repeat its last token), handed over
through numpy (``repro_torch.interop``).  The JAX side is jitted
(``whisper._encode``, ``forward``, ``prefill``, ``decode_step``, and its
``ServeEngine``'s own legacy programs).

Tolerance.  Encoder outputs, logits and caches agree within
2^-5 * max|value| (8 bf16 ulps at the largest), the bar of the other
serving slices: the port's prefill runs its attention through the flash
kernel's plain version (f32 probabilities) where JAX's blocked attention
rounds q * scale, k and p to bf16.  Greedy streams match token for token,
except where the JAX engine's own top-2 logit margin for that token (its
legacy prefill and decode calls recorded as they ran) is under that bar;
the test reports the first such position.  Port-internal properties
(``Slice.serve``, the ignored ``kv_block`` and ``greedy``) are bitwise.
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
from repro.models import whisper as JWH
from repro.serve.engine import ServeEngine as JEngine
from repro.serve.engine import SliceSpec as JSpec
from repro_torch import interop
from repro_torch.cluster import Supercomputer
from repro_torch.configs import registry as TREG
from repro_torch.launch import serve as TSERVE
from repro_torch.models import api as TAPI
from repro_torch.models import whisper as TWH
from repro_torch.serve.engine import ServeEngine as TEngine
from repro_torch.serve.engine import SliceSpec as TSpec

ARCH = "whisper-small"
LOGIT_REL_TOL = 2.0 ** -5
TIED_EMBED_SCALE = 0.05
ENGINE_ATTN_DAMP = 0.1
SPEC = dict(slots=2, max_len=40, prompt_len=16, chunk=4)
# 5 requests over 2 slots (three admission waves); one request of one
# token; the longest decode runs 12 steps past a prompt of 16
PROMPT_LENS = (12, 16, 9, 20, 5)
BUDGETS = (10, 1, 8, 6, 12)


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
            elif k in ("w", "b"):
                tree[k] = (v + 0.1 * rng.standard_normal(v.shape)).astype(
                    np.float32)
    perturb(p)
    p["embed"] = p["embed"] * np.float32(TIED_EMBED_SCALE)
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


def _batch(seed, B, S_enc, T, d, torch_side):
    rng = np.random.default_rng(seed)
    frames = rng.standard_normal((B, S_enc, d)).astype(np.float32)
    toks = rng.integers(0, 512, size=(B, T)).astype(np.int32)
    if torch_side:
        return {"frames": torch.from_numpy(frames),
                "tokens": torch.from_numpy(toks).long()}
    return {"frames": jnp.asarray(frames), "tokens": jnp.asarray(toks)}


_jencode = jax.jit(JWH._encode, static_argnums=0)
_jforward = jax.jit(lambda cfg, p, b: JWH.forward(cfg, p, b)[0],
                    static_argnums=0)
_jprefill = jax.jit(JWH.prefill, static_argnums=0,
                    static_argnames="max_len")
_jstep = jax.jit(JWH.decode_step, static_argnums=0)


def _drive(eng, prompts, drive="run"):
    """Serve ``prompts`` with their budgets through ``run()`` or repeated
    ``step_chunk()``; returns (streams, stats or None)."""
    reqs = [eng.submit(p, max_new_tokens=m)
            for p, m in zip(prompts, BUDGETS)]
    stats = None
    if drive == "run":
        stats = eng.run()
    else:
        for _ in range(200):
            if getattr(eng, drive)() == 0 and not eng.pending:
                break
    return [list(r.out_tokens) for r in reqs], stats


def _recorder(eng, record):
    """Wrap a model call of the legacy path so each output's logits row is
    kept under (rid, index of the token it picks) for every slot whose
    request is still owed tokens when the call runs."""
    def wrap(fn):
        def call(*a, **kw):
            out = fn(*a, **kw)
            rows = np.asarray(out[0].float() if torch.is_tensor(out[0])
                              else out[0], np.float32)
            for slot, r in enumerate(eng.active):
                if r is not None and not r.done:
                    record[(r.rid, len(r.out_tokens))] = rows[slot]
            return out
        return call
    return wrap


def _jax_served(model, prompts, drive):
    eng = JEngine(model["jcfg"], model["jp"], JSpec(**SPEC))
    record = {}
    wrap = _recorder(eng, record)
    eng._prefill, eng._decode = wrap(eng._prefill), wrap(eng._decode)
    return (*_drive(eng, prompts, drive), record)


def _port_served(model, prompts, drive):
    eng = TEngine(model["tcfg"], model["tp"], TSpec(**SPEC), device="cpu")
    record = {}
    wrap = _recorder(eng, record)
    calls = {n: getattr(TAPI, n) for n in ("prefill", "decode_step")}
    try:
        for n, fn in calls.items():
            setattr(TAPI, n, wrap(fn))
        return (*_drive(eng, prompts, drive), record)
    finally:
        for n, fn in calls.items():
            setattr(TAPI, n, fn)


DRIVES = ("run", "step_chunk")


@pytest.fixture(scope="module")
def engine_model(model):
    """The engine's weights: ``model``'s with the self- and
    cross-attention output projections damped by ENGINE_ATTN_DAMP.  Zero
    frames make the cross-attention output one vector at every position,
    and with it at full strength every reduced stream falls onto one
    repeated token at once; damped, the streams move between tokens."""
    p = {k: v for k, v in model["np"].items()}
    p["decoder"] = {k: dict(v) for k, v in p["decoder"].items()}
    for blk in ("attn", "xattn"):
        p["decoder"][blk]["wo"] = (p["decoder"][blk]["wo"]
                                   * np.float32(ENGINE_ATTN_DAMP))
    return dict(model, np=p, jp=jax.tree.map(jnp.asarray, p),
                tp=interop.params_from_numpy(p))


@pytest.fixture(scope="module")
def served(engine_model, prompts):
    """Both engines' streams, stats and logits records, for each drive."""
    return {drive: (_jax_served(engine_model, prompts, drive),
                    _port_served(engine_model, prompts, drive))
            for drive in DRIVES}


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
    """whisper-small is registered under the reference's name, and every
    field of its copy (``ModelConfig``, its ``AttentionConfig``, the
    encoder fields among them) equals the reference's."""
    assert ARCH in TREG.ARCHS
    t, j = getattr(TREG, getter)(ARCH), getattr(JREG, getter)(ARCH)
    assert t.name == ARCH and t.family == "audio"
    for f in dataclasses.fields(t):
        if f.name != "attention":
            assert getattr(t, f.name) == getattr(j, f.name), f.name
    assert dataclasses.asdict(t.attention) == dataclasses.asdict(j.attention)
    assert t.encoder_layers == j.encoder_layers > 0
    assert t.encoder_seq_reduction == j.encoder_seq_reduction


def test_split_seq_matches_reference():
    cfg = TREG.get_reduced(ARCH)
    for n in (2, 3, 4, 7, 448, 1001):
        assert TWH.split_seq(cfg, n) == JWH.split_seq(cfg, n)


def test_full_width_tree_matches_reference_shapes():
    """Every leaf of the port's full-width tree (meta tensors, bf16) has the
    shape of ``jax.eval_shape`` of the reference's ``init_params``: 12 + 12
    layers, layernorm scales and biases, the cross-attention without qkv
    biases, the tied 51865-row embedding (no ``head``); 0.238e9
    parameters."""
    jcfg, tcfg = JREG.get_config(ARCH), TREG.get_config(ARCH)
    want = {k: tuple(v.shape) for k, v in _leaves(jax.eval_shape(
        lambda k: JAPI.init_params(jcfg, k), jax.random.PRNGKey(0))).items()}
    got = _leaves(TAPI.param_shapes(tcfg))
    assert {k: tuple(v.shape) for k, v in got.items()} == want
    assert all(v.dtype == torch.bfloat16 for v in got.values())
    assert got["/decoder/xattn/wq"].shape == (12, 768, 12, 64)
    assert "/decoder/xattn/bq" not in got and "/head" not in got
    assert sum(v.numel() for v in got.values()) == 238_108_416


def test_interop_carries_every_leaf(model):
    j, t = _leaves(model["np"]), _leaves(model["tp"])
    assert j.keys() == t.keys()
    for path, a in j.items():
        b = t[path]
        assert tuple(b.shape) == a.shape and b.dtype == torch.float32, path
        np.testing.assert_array_equal(b.numpy(), a, err_msg=path)


# ---------------------------------------------------------------------------
# Against JAX: model paths
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flash", [False, True], ids=["plain", "row2"])
def test_encode_matches_jax(model, flash):
    """The encoder over 24 random frames: plain ``blocked_attention`` (the
    forward's) and row 2's plain version (the prefill's), each within the
    bar of JAX's output."""
    d = model["tcfg"].d_model
    jb = _batch(3, 2, 24, 4, d, False)
    tb = _batch(3, 2, 24, 4, d, True)
    want = _jencode(model["jcfg"], model["jp"], jb["frames"])
    got = TWH._encode(model["tcfg"], model["tp"], tb["frames"], flash=flash)
    assert got.dtype == torch.bfloat16
    _close(got, want, f"encoder output, flash={flash}")


def test_forward_logits_match_jax(model):
    """Teacher-forced logits (B 2, 20 frames, 12 tokens) within the bar."""
    d = model["tcfg"].d_model
    want = _jforward(model["jcfg"], model["jp"], _batch(4, 2, 20, 12, d,
                                                        False))
    got, aux = TAPI.forward(model["tcfg"], model["tp"],
                            _batch(4, 2, 20, 12, d, True))
    assert got.dtype == torch.float32 and float(aux) == 0.0
    _close(got, want, "forward logits")


def test_prefill_logits_and_caches_match_jax(model):
    """A prefill of 12 tokens over 16 frames into 20 self rows: the
    last-position logits, the self K/V rows (the rest zero) and the cross
    K/V of every layer within the bar; ``pos`` 12."""
    d = model["tcfg"].d_model
    jl, jc = _jprefill(model["jcfg"], model["jp"],
                       _batch(5, 3, 16, 12, d, False), max_len=20)
    tl, tc = TAPI.prefill(model["tcfg"], model["tp"],
                          _batch(5, 3, 16, 12, d, True), max_len=20)
    _close(tl, jl, "prefill logits")
    a = model["tcfg"].attention
    assert tuple(tc.k.shape) == (2, 3, 20, a.num_kv_heads, a.head_dim)
    assert tuple(tc.xk.shape) == (2, 3, 16, a.num_kv_heads, a.head_dim)
    assert int(tc.pos) == int(jc.pos) == 12 and not tc.k[:, :, 12:].any()
    for name in ("k", "v", "xk", "xv"):
        _close(getattr(tc, name), getattr(jc, name), f"cache {name}")


def test_decode_steps_match_jax_and_clamp_past_max_len(model):
    """Six decode steps of random tokens after a prefill of 12 into 14 self
    rows: logits within the bar at every step, ``pos`` 18 at the end.  The
    last four steps run past the cache's end: each overwrites row 13 (the
    reference's clamped ``dynamic_update_slice``), nothing grows, and the
    caches still agree with JAX's."""
    jcfg, tcfg, jp, tp = model["jcfg"], model["tcfg"], model["jp"], model["tp"]
    d = tcfg.d_model
    _, jc = _jprefill(jcfg, jp, _batch(6, 3, 16, 12, d, False), max_len=14)
    _, tc = TAPI.prefill(tcfg, tp, _batch(6, 3, 16, 12, d, True), max_len=14)
    xk0 = tc.xk.clone()
    rng = np.random.default_rng(7)
    for step in range(6):
        tk = rng.integers(0, 512, size=3).astype(np.int32)
        jl, jc = _jstep(jcfg, jp, jc, jnp.asarray(tk))
        tl, tc = TAPI.decode_step(tcfg, tp, tc, torch.from_numpy(tk).long())
        _close(tl, jl, f"decode step {step}")
        assert int(tc.pos) == int(jc.pos) == 13 + step
        if step >= 2:                       # past the end: row 13 again
            assert tc.k.shape[2] == 14
            _close(tc.k[:, :, 13], jc.k[:, :, 13], f"clamped row, {step}")
    for name in ("k", "v"):
        _close(getattr(tc, name), getattr(jc, name), f"cache {name}")
    assert torch.equal(tc.xk, xk0)


def test_init_cache_layout():
    cfg = TREG.get_reduced(ARCH)
    c = TAPI.init_cache(cfg, 3, 10, enc_len=7, device="cpu")
    assert tuple(c.k.shape) == (2, 3, 10, 4, 16)
    assert tuple(c.xv.shape) == (2, 3, 7, 4, 16)
    assert c.k.dtype == torch.bfloat16 and int(c.pos) == 0
    assert TAPI.init_cache(cfg, 1, 5, device="cpu").xk.shape[2] == 5


# ---------------------------------------------------------------------------
# Against JAX: the legacy engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("drive", DRIVES)
def test_engine_streams_match_jax(engine_model, served, drive):
    """5 requests over 2 slots through each framework's ``ServeEngine``
    (the legacy path: an admission re-prefills the whole batch, one decode
    step a host sync), by ``run()`` and by ``step_chunk()`` (which, as the
    reference's, also admits while other slots are mid-request): every
    budget met (one request of one token), ids in the vocabulary, the
    logits behind every token within the bar of the JAX engine's, and the
    streams token for token but at a near tie of the JAX engine's own
    logits (reported).  Past a request's first split its contexts differ,
    so nothing after it is compared."""
    (jstreams, _, jrec), (tstreams, _, trec) = served[drive]
    assert len(trec) == len(jrec) == sum(BUDGETS)
    for rid, (js, ts) in enumerate(zip(jstreams, tstreams)):
        assert len(ts) == len(js) == BUDGETS[rid]
        assert all(0 <= t < engine_model["tcfg"].vocab_size for t in ts)
        diff = [i for i, (a, b) in enumerate(zip(js, ts)) if a != b]
        last = diff[0] if diff else len(js) - 1
        for i in range(last + 1):
            np.testing.assert_allclose(
                trec[(rid, i)], jrec[(rid, i)], atol=_tol(jrec[(rid, i)]),
                rtol=0, err_msg=f"{drive}: request {rid} token {i}")
        if not diff:
            continue
        i = diff[0]
        row = np.sort(jrec[(rid, i)])
        margin, tol = float(row[-1] - row[-2]), _tol(row)
        assert margin < tol, (
            f"{drive}: request {rid}: token {i} differs (jax {js[i]}, port "
            f"{ts[i]}) with a JAX top-2 margin {margin:.4f} >= tolerance "
            f"{tol:.4f}")
        warnings.warn(f"whisper {drive} request {rid}: streams part at "
                      f"token {i}, a near tie (JAX top-2 margin "
                      f"{margin:.4f} < {tol:.4f})")


def test_streams_move_between_tokens(served):
    """The engine test's weights give streams that are not one repeated
    token (so a wrong token fed back would show)."""
    streams = served["run"][1][0]
    assert sum(len(set(s)) > 1 for s in streams) >= 2


def test_run_stats_match_jax(served):
    """``run()``'s request and token counts equal JAX's, and so do its
    decode steps (the schedule follows the budgets only); ``chunk`` 1."""
    (_, js, _), (_, ts, _) = served["run"]
    for k in ("requests_done", "tokens", "decode_steps", "chunk"):
        assert ts[k] == js[k], k
    assert ts["requests_done"] == len(BUDGETS)
    assert ts["tokens"] == sum(BUDGETS) and ts["chunk"] == 1
    assert ts["mean_ttft_s"] > 0 and ts["p50_chunk_s"] > 0


@pytest.mark.parametrize("extra", [dict(kv_block=8), dict(greedy=False),
                                   dict(chunk=1)],
                         ids=["kv_block", "sampling", "chunk1"])
def test_kv_block_sampling_and_chunk_leave_run_unchanged(
        engine_model, prompts, served, extra):
    """As the reference's legacy path: no pooled cache (``kv_block``),
    greedy picks whatever ``greedy`` says, and ``run()`` steps one token
    at a time whatever ``chunk`` is: the same streams, bitwise."""
    eng = TEngine(engine_model["tcfg"], engine_model["tp"],
                  TSpec(**{**SPEC, **extra}), device="cpu")
    assert _drive(eng, prompts)[0] == served["run"][1][0]


def test_step_serves_what_run_serves(engine_model, prompts, served):
    """``step()`` admits only when no request is active, as ``run()`` does:
    the same streams, bit for bit."""
    eng = TEngine(engine_model["tcfg"], engine_model["tp"], TSpec(**SPEC),
                  device="cpu")
    assert _drive(eng, prompts, "step")[0] == served["run"][1][0]


def test_slice_serve_equals_the_engine(engine_model, prompts, served):
    sl = Supercomputer(device="cpu").allocate((4, 4, 4))
    session = sl.serve(engine_model["tcfg"], engine_model["tp"],
                       TSpec(**SPEC))
    reqs = [session.submit(p, max_new_tokens=m)
            for p, m in zip(prompts, BUDGETS)]
    assert session.run()["requests_done"] == len(prompts)
    assert [list(r.out_tokens) for r in reqs] == served["run"][1][0]
    sl.free()


def test_cli_serves_reduced_whisper_on_cpu(capsys):
    stats = TSERVE.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                         "--requests", "3", "--slots", "2",
                         "--new-tokens", "5"])
    assert stats["requests_done"] == 3 and stats["tokens"] == 15
    assert stats["chunk"] == 1
    assert '"requests_done": 3' in capsys.readouterr().out


def test_unported_audio_paths_are_refused(model):
    """As the reference: whisper has no per-slot insert (``prefill_slot``,
    ``decode_n``); int8 weights and training wait for item 11(i); the
    decoder families' shared-position ``decode_step`` for item 5."""
    cfg, tp = model["tcfg"], model["tp"]
    with pytest.raises(NotImplementedError, match="legacy full-batch"):
        TAPI.prefill_slot(cfg, tp, {}, None, 0)
    with pytest.raises(NotImplementedError, match="legacy per-token"):
        TAPI.decode_n(cfg, tp, None, [0], [0], [1], num_steps=1)
    with pytest.raises(NotImplementedError, match=r"item 11\(i\)"):
        TEngine(cfg, tp, TSpec(**SPEC, quant="int8"), device="cpu")
    with pytest.raises(NotImplementedError, match="item 5"):
        TAPI.decode_step(TREG.get_reduced("olmo-1b"), {}, None, None)
