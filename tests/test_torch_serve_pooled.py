"""The port's pooled prefix-shared KV engine (``SliceSpec(kv_block > 0)``)
on reduced olmo-1b, against the JAX package and against itself.

Same weights on both sides (JAX init, handed over through numpy).

  * ``layers.blocked_attention`` against JAX's on bf16 inputs (GQA, a
    window, a softcap, lanes at kv position -1, one chunk and several):
    within 2^-7 (one bf16 rounding of the output) plus 2^-7 relative.
  * ``api.prefill_suffix`` against JAX's on the same params, pool, tokens,
    starts, valid counts and tables (shared blocks, an idle row, an
    unadmitted table), in one dispatch and in chained ones: logits within
    LOGIT_REL_TOL = 2^-5 of the largest |logit| (the bar of
    ``tests/test_torch_serve.py``), each written pool row within
    LOGIT_REL_TOL of the largest |K| or |V| of its layer (bf16 rows from
    bf16 matmuls that the two frameworks round at other places), and every
    other row bitwise as it was.
  * The port's pooled engine against the JAX pooled engine on a
    shared-header trace: greedy streams token for token except at a JAX
    near tie (reported), and ``prefill_flops_proxy``, ``kv_prompt_tokens``,
    ``kv_shared_tokens`` and the pool accounting of ``kv_stats()`` equal.
  * Within the port, bitwise: sharing on and off serve the same tokens at
    ``suffix_len == kv_block`` and at ``suffix_len = 4 * kv_block`` (where
    the arms cut the suffix at other offsets), and both the dense engine's
    (``tests/test_serve_fastpath.py``'s pin, on its weights).
  * ``prefix_lookup``, the ``export_inflight`` round trip and its migration
    counters against JAX's, and a leak-free ``kv_close`` after each.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as JREG
from repro.models import api as JAPI
from repro.models import layers as JL
from repro.models import transformer as JTF
from repro.serve.engine import ServeEngine as JEngine
from repro.serve.engine import SliceSpec as JSpec
from repro_torch import interop
from repro_torch.configs import registry as TREG
from repro_torch.models import api as TAPI
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TTF
from repro_torch.serve.engine import ServeEngine as TEngine
from repro_torch.serve.engine import SliceSpec as TSpec

LOGIT_REL_TOL = 2.0 ** -5
BASE = dict(slots=3, max_len=64, prompt_len=40, chunk=4)
POOLED = dict(BASE, kv_block=8, suffix_len=8)


def _tol(x) -> float:
    return LOGIT_REL_TOL * float(np.abs(np.asarray(x, np.float32)).max())


@pytest.fixture(scope="module", params=[1.0, 0.1], ids=["init", "embed0.1"])
def model(request):
    """Reduced olmo-1b from JAX's init; ``embed0.1`` shrinks the tied
    embedding so streams do not just repeat one token."""
    cfg = JREG.get_reduced("olmo-1b")
    p = jax.tree.map(np.asarray, JAPI.init_params(cfg, jax.random.PRNGKey(0)))
    p["embed"] = p["embed"] * np.float32(request.param)
    return dict(jcfg=cfg, tcfg=TREG.get_reduced("olmo-1b"),
                jp=jax.tree.map(jnp.asarray, p),
                tp=interop.params_from_numpy(p), scale=request.param)


def _prompts(vocab, n=6):
    """``tests/test_serve_fastpath.py``'s shared-header mix: a 24-token
    header (3 blocks of 8) with a 3-11 token tail, every third prompt a
    stranger of 20 tokens."""
    rng = np.random.RandomState(11)
    header = rng.randint(0, vocab, (24,)).astype(np.int32)
    out = []
    for i in range(n):
        tail = rng.randint(0, vocab, (rng.randint(3, 12),)).astype(np.int32)
        out.append(np.concatenate([header, tail]) if i % 3 != 2
                   else rng.randint(0, vocab, (20,)).astype(np.int32))
    return header, out


def _serve(engine, prompts, new=5):
    reqs = [engine.submit(p, max_new_tokens=new) for p in prompts]
    engine.run(max_steps=500)
    assert all(r.done for r in reqs)
    return [list(r.out_tokens) for r in reqs]


def _port(model, prompts, **spec):
    eng = TEngine(model["tcfg"], model["tp"], TSpec(**spec), device="cpu")
    return eng, _serve(eng, prompts)


# ---------------------------------------------------------------------------
# blocked_attention and prefill_suffix against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window,softcap,kv_chunk", [
    (None, None, 1024), (5, None, 1024), (None, 30.0, 1024), (7, 20.0, 8)])
def test_blocked_attention_matches_jax(window, softcap, kv_chunk):
    rng = np.random.default_rng(4)
    B, Tq, S, H, KH, d = 3, 6, 20, 4, 2, 16
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, Tq, H, d), (B, S, KH, d), (B, S, KH, d)))
    q, k, v = (np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
               for x in (q, k, v))
    start = np.array([0, 5, 13], np.int32)
    q_pos = start[:, None] + np.arange(Tq, dtype=np.int32)[None]
    lane = np.arange(S, dtype=np.int32)[None]
    kv_pos = np.where(lane < (start + Tq - 2)[:, None], lane, -1)
    kw = dict(window=window, softcap=softcap, scale=0.3, kv_chunk=kv_chunk)
    want = np.asarray(JL.blocked_attention(
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)),
        jnp.asarray(q_pos), jnp.asarray(kv_pos), **kw).astype(jnp.float32))
    got = TL.blocked_attention(
        *(torch.tensor(x).bfloat16() for x in (q, k, v)),
        torch.tensor(q_pos), torch.tensor(kv_pos), **kw)
    assert got.dtype == torch.bfloat16 and got.shape == (B, Tq, H, d)
    np.testing.assert_allclose(got.float().numpy(), want, atol=2.0 ** -7,
                               rtol=2.0 ** -7)


NB, BS, NBT, T = 20, 8, 4, 8            # pool blocks, block, table, width
TABLES = np.array([[0, 1, 2, 3],        # rows 0 and 1 share blocks 0, 1
                   [0, 1, 4, 5],
                   [6, 7, 8, 9],        # an idle row
                   [NB] * NBT], np.int32)   # an unadmitted slot


def _pool(cfg, seed):
    """A pool of random bf16 K/V rows (as numpy f32), so that rows a
    dispatch must not touch are checkable."""
    a = cfg.attention
    shape = (cfg.num_layers, NB, BS, a.num_kv_heads, a.head_dim)
    rng = np.random.default_rng(seed)
    kv = [rng.standard_normal(shape).astype(np.float32) for _ in range(2)]
    return [np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
            for x in kv]


def _dispatches(chained: bool):
    """(tokens, start, valid) of each dispatch: rows 0 and 1 resume after
    their shared 16 tokens, row 2 is idle, row 3 unadmitted."""
    rng = np.random.default_rng(3)
    seqs = [rng.integers(0, 512, size=n) for n in (29, 21)]
    spans = ([[(16, 8), (16, 5)], [(24, 5), (21, 0)]] if chained
             else [[(16, 8), (16, 5)]])
    out = []
    for chunk in spans:
        tok = np.zeros((4, T), np.int32)
        st = np.zeros((4,), np.int32)
        vd = np.zeros((4,), np.int32)
        for row, (s0, v) in enumerate(chunk):
            tok[row, :v] = seqs[row][s0:s0 + v]
            st[row], vd[row] = s0, v
        out.append((tok, st, vd))
    return out


@pytest.mark.parametrize("chained", [False, True], ids=["one", "chained"])
def test_prefill_suffix_matches_jax(model, chained):
    jcfg, tcfg = model["jcfg"], model["tcfg"]
    k0, v0 = _pool(jcfg, 5)
    jc = JTF.Cache(k=jnp.asarray(k0, jnp.bfloat16),
                   v=jnp.asarray(v0, jnp.bfloat16),
                   pos=jnp.zeros((), jnp.int32))
    tc = TTF.Cache(k=torch.tensor(k0).bfloat16(),
                   v=torch.tensor(v0).bfloat16(),
                   pos=torch.zeros((), dtype=torch.int32))
    jfn = jax.jit(JAPI.prefill_suffix, static_argnums=0)
    written = np.zeros((NB, BS), bool)
    for tok, st, vd in _dispatches(chained):
        jl, jc = jfn(jcfg, model["jp"], jc, jnp.asarray(tok),
                     jnp.asarray(st), jnp.asarray(vd), jnp.asarray(TABLES))
        tl, tc = TAPI.prefill_suffix(tcfg, model["tp"], tc,
                                     torch.from_numpy(tok), st, vd, TABLES)
        jl = np.asarray(jl)
        live = vd > 0
        np.testing.assert_allclose(tl.numpy()[live], jl[live],
                                   atol=_tol(jl[live]), rtol=0)
        for row in np.nonzero(live)[0]:
            for pos in range(st[row], st[row] + vd[row]):
                written[TABLES[row, pos // BS], pos % BS] = True
    for name, init in (("k", k0), ("v", v0)):
        want = np.asarray(getattr(jc, name).astype(jnp.float32))
        got = getattr(tc, name).float().numpy()
        # every row no dispatch wrote is bitwise as it was, on both sides
        np.testing.assert_array_equal(got[:, ~written], init[:, ~written])
        np.testing.assert_array_equal(want[:, ~written], init[:, ~written])
        for l in range(jcfg.num_layers):
            w = want[l][written]
            np.testing.assert_allclose(got[l][written], w, atol=_tol(w),
                                       rtol=0, err_msg=f"{name} layer {l}")
    assert written.sum() == (18 if chained else 13)


# ---------------------------------------------------------------------------
# The pooled engine against JAX's
# ---------------------------------------------------------------------------

def _jax_margin(model, prompt, out_tokens, i):
    """JAX top-2 logit margin (and tolerance) where token ``i`` of a pooled
    stream was chosen: the prompt is left-aligned, not padded."""
    ctx = np.concatenate([prompt[-BASE["prompt_len"]:],
                          np.asarray(out_tokens[:i], np.int32)])
    logits, _ = JTF.forward(model["jcfg"], model["jp"],
                            {"tokens": jnp.asarray(ctx)[None]})
    last = np.sort(np.asarray(logits[0, -1]))
    return float(last[-1] - last[-2]), _tol(last)


STAT_KEYS = ("num_blocks", "block_size", "free_blocks", "allocated_blocks",
             "trie_nodes", "table_refs", "shared_table_blocks",
             "prefill_flops_proxy", "kv_prompt_tokens", "kv_shared_tokens",
             "kv_migrated_shared_blocks", "kv_migrated_suffix_blocks")


def test_pooled_engine_matches_jax(model):
    _, prompts = _prompts(model["jcfg"].vocab_size)
    jeng = JEngine(model["jcfg"], model["jp"], JSpec(**POOLED))
    js = _serve(jeng, prompts)
    teng, ts = _port(model, prompts, **POOLED)
    for r, (a, b) in enumerate(zip(js, ts)):
        assert len(a) == len(b) == 5
        diff = [i for i, (x, y) in enumerate(zip(a, b)) if x != y]
        if diff:
            margin, tol = _jax_margin(model, prompts[r], a, diff[0])
            assert margin < tol, (r, diff[0], a, b, margin, tol)
            warnings.warn(f"request {r}: streams part at token {diff[0]}, "
                          f"a near tie ({margin:.4f} < {tol:.4f})")
    want, got = jeng.kv_stats(), teng.kv_stats()
    assert set(got) == set(want) == set(STAT_KEYS)
    assert got == want and got["kv_shared_tokens"] > 0
    jeng.kv_close()
    teng.kv_close()


# ---------------------------------------------------------------------------
# Within the port: sharing is bitwise-invisible
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("suffix_len", [8, 32], ids=["block", "4block"])
def test_share_is_bitwise_and_matches_dense(model, suffix_len):
    _, prompts = _prompts(model["jcfg"].vocab_size)
    spec = dict(POOLED, suffix_len=suffix_len)
    share_eng, share = _port(model, prompts, **spec)
    noshare_eng, noshare = _port(model, prompts, **spec, kv_share=False)
    assert share == noshare
    assert share_eng.prefill_flops_proxy < noshare_eng.prefill_flops_proxy
    assert share_eng.kv_shared_tokens > 0 == noshare_eng.kv_shared_tokens
    share_eng.kv_close()
    noshare_eng.kv_close()
    if model["scale"] == 1.0:
        # the dense engine left-pads its prompts; on these weights the
        # streams agree all the same, as the reference pins
        assert share == _port(model, prompts, **BASE)[1]


# ---------------------------------------------------------------------------
# Introspection and migration
# ---------------------------------------------------------------------------

def test_prefix_lookup_scores_published_header(model):
    header, prompts = _prompts(model["jcfg"].vocab_size)
    eng = TEngine(model["tcfg"], model["tp"], TSpec(**POOLED), device="cpu")
    probe = np.concatenate([header, header[:5]])
    assert eng.prefix_lookup(probe) == 0               # cold trie
    _serve(eng, prompts[:2])
    jeng = JEngine(model["jcfg"], model["jp"], JSpec(**POOLED))
    _serve(jeng, prompts[:2])
    for p in (probe, header[::-1].copy(), prompts[2], prompts[0]):
        assert eng.prefix_lookup(p) == jeng.prefix_lookup(p)
    assert eng.prefix_lookup(probe) >= 16
    assert eng.prefix_lookup(header[::-1].copy()) == 0
    dense = TEngine(model["tcfg"], model["tp"], TSpec(**BASE), device="cpu")
    assert dense.prefix_lookup(probe) == 0
    dense.kv_close()                                   # a no-op
    eng.kv_close()
    assert eng.kvpool.stats()["allocated_blocks"] == 0


def test_zero_decoded_export_roundtrips_pooled(model):
    """``tests/test_serve_fastpath.py``'s round trip on the pooled engine:
    a request exported with only its admission token re-prefills
    ``prompt + out_tokens`` elsewhere and serves exactly the rest."""
    spec = TSpec(slots=2, max_len=64, prompt_len=16, chunk=4, kv_block=8,
                 suffix_len=8)
    prompt = np.arange(10, dtype=np.int32) + 3
    mk = lambda: TEngine(model["tcfg"], model["tp"], spec, device="cpu")
    ref = mk()
    want = _serve(ref, [prompt], new=6)[0]
    e1 = mk()
    r = e1.submit(prompt, max_new_tokens=6)
    e1._admit()
    assert len(r.out_tokens) == 1 and not r.done
    assert e1.export_inflight() == [r] and not e1.queue
    assert not e1.tables.lt(e1.kvpool.num_blocks).any()
    e1.kv_close()
    e2 = mk()
    cont = np.concatenate([prompt, np.asarray(r.out_tokens, np.int32)])
    rest = _serve(e2, [cont], new=5)[0]
    assert r.out_tokens + rest == want and len(want) == 6
    ref.kv_close()
    e2.kv_close()


def test_export_migration_counters_match_jax(model):
    """Publish the header with one request, then export a wave in flight
    that maps it: the shared / private block split of the moved requests
    equals JAX's."""
    _, prompts = _prompts(model["jcfg"].vocab_size)
    engines = [JEngine(model["jcfg"], model["jp"], JSpec(**POOLED)),
               TEngine(model["tcfg"], model["tp"], TSpec(**POOLED),
                       device="cpu")]
    out = []
    for e in engines:
        e.submit(prompts[0], max_new_tokens=2)
        e.run()
        for p in prompts[1:]:
            e.submit(p, max_new_tokens=20)
        e.step_chunk()                  # a wave admitted and decoding
        moved = e.export_inflight()
        out.append(([m.rid for m in moved], e.kv_stats()))
        e.kv_close()
    assert out[0] == out[1]
    stats = out[1][1]
    assert stats["kv_migrated_suffix_blocks"] > 0
    assert stats["kv_migrated_shared_blocks"] > 0
