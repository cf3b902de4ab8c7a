"""The port's pooled block-table decode and int8-KV decode, against the JAX
package on the CPU.

  * ``quant.quantize_kv`` / ``dequantize_kv``: bitwise the reference's.
  * The plain versions (``kernels/ref.py``) of three decode kernels:
    the block-table decode
    (``paged_decode_attention_bt_ref``) and the int8 decodes (both plain
    versions with ``k_scale``/``v_scale``), against the reference's f32
    oracles within ATOL = RTOL = 2e-5 (the same f32 math in another
    summation order, as ``tests/test_torch_kernels_ref.py``) and against
    the Pallas kernels in interpret mode within PALLAS_TOL = 2e-3 (the
    reference's own bar for its kernels, ``tests/test_decode_attention.py``).
  * ``ops`` on the CPU with scales against the reference's ``ops`` with
    ``impl="xla"`` (both dequantise to ``q.dtype`` first): f32 within
    ATOL; bf16 outputs within one bf16 rounding, BF16_TOL = 2^-7.
  * Reduced olmo-1b with the JAX weights (through ``interop``): one pooled
    ``decode_step_paged(tables=)`` and ``api.decode_n(tables=)`` against
    JAX's on the same pool and tables, at the bar of
    ``tests/test_torch_serve.py`` (LOGIT_REL_TOL = 2^-5 of the largest
    |logit|; greedy streams equal except at a JAX near tie, reported).
  * The port's own invariants, bitwise: ``decode_n(tables=)`` is the dense
    ``decode_n`` on the gathered view, a loop of pooled steps writes the
    pool ``decode_n(tables=)`` writes, shared and unowned blocks stay as
    they were, and ``decode_n(tables=)`` does not depend on the chunk.
"""
import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as JREG
from repro.kernels import ops as JOPS
from repro.kernels import ref as JREF
from repro.kernels.decode_attention import (
    paged_decode_attention_bt_kernel_call, paged_decode_attention_kernel_call)
from repro.models import api as JAPI
from repro.models import quant as JQ
from repro.models import transformer as JTF
from repro_torch import interop
from repro_torch.configs import registry as TREG
from repro_torch.kernels import ops as TOPS
from repro_torch.kernels import ref as TREF
from repro_torch.models import api as TAPI
from repro_torch.models import quant as TQ
from repro_torch.models import transformer as TTF
from test_torch_cuda import fill_pool

ATOL = RTOL = 2e-5
PALLAS_TOL = 2e-3
BF16_TOL = 2.0 ** -7
LOGIT_REL_TOL = 2.0 ** -5


def _arr(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, tol=ATOL):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


# ---------------------------------------------------------------------------
# quantize_kv
# ---------------------------------------------------------------------------

def _kv_rows(dtype):
    rng = np.random.default_rng(0)
    x = _arr(rng, 3, 37, 4, 16) * 3.0
    # rows whose quotients land on .5 (round half to even), an all-zero row
    # (the 1e-12 floor) and one row scaled far down
    x[0, 0, 0] = np.array([127, 63.5, -0.5, 1.5, 2.5, -2.5, 0.5, 126.5,
                           -127, 3.5, 0, 0, 0, 0, 0, 0], np.float32)
    x[0, 1, 0] = 0.0
    x[1, 2, 3] *= 1e-30
    if dtype == "bf16":
        x = np.asarray(jnp.asarray(x, jnp.bfloat16))
        return jnp.asarray(x), _t(x.astype(np.float32)).to(torch.bfloat16)
    return jnp.asarray(x), _t(x)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_quantize_kv_is_bitwise_jax(dtype):
    jx, tx = _kv_rows(dtype)
    jq, js = JQ.quantize_kv(jx)
    tq, ts = TQ.quantize_kv(tx)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert tq[0, 0, 0, :10].tolist() == [127, 64, 0, 2, 2, -2, 0, 126, -127,
                                         4]
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        want = np.asarray(JQ.dequantize_kv(jq, js, dtype=jdt), np.float32)
        got = TQ.dequantize_kv(tq, ts, dtype=tdt)
        assert got.dtype == tdt
        np.testing.assert_array_equal(got.float().numpy(), want)


# ---------------------------------------------------------------------------
# The plain versions against the reference
# ---------------------------------------------------------------------------

NB, BS, NBLK = 16, 8, 4                   # pool blocks, block size, per slot
POOL_CASES = [                            # (H, KH, d), options
    ((4, 2, 16), dict()),
    ((4, 2, 16), dict(window=9)),
    ((8, 8, 16), dict(softcap=5.0)),
    ((4, 1, 32), dict(window=13, softcap=3.0, scale=0.3)),
]


def _pool_inputs(H, KH, d, seed=3):
    """4 slots over a pool of NB blocks of BS rows: slot 1 shares slot 0's
    first block, slot 2 is empty (seq_len 0), slot 3's table ends in the
    sentinel NB (unadmitted tail, past its seq_len); the pool blocks no
    table names hold garbage like any other block."""
    rng = np.random.default_rng(seed)
    q = _arr(rng, 4, H, d)
    k, v = _arr(rng, NB, BS, KH, d), _arr(rng, NB, BS, KH, d)
    perm = rng.permutation(NB)
    tables = perm[:4 * NBLK].reshape(4, NBLK).astype(np.int32)
    tables[1, 0] = tables[0, 0]
    tables[3, 2:] = NB
    lens = np.array([NBLK * BS, 21, 0, 2 * BS - 3], np.int32)
    return q, k, v, lens, tables


@pytest.mark.parametrize("shape,kw", POOL_CASES, ids=str)
def test_bt_ref_matches_oracle_and_pallas(shape, kw):
    q, k, v, lens, tables = _pool_inputs(*shape)
    got = TREF.paged_decode_attention_bt_ref(*map(_t, (q, k, v, lens,
                                                       tables)), **kw)
    ja = [jnp.asarray(a) for a in (q, k, v, lens, tables)]
    _close(got, JREF.paged_decode_attention_bt_ref(*ja, **kw))
    _close(got, paged_decode_attention_bt_kernel_call(*ja, interpret=True,
                                                      **kw), PALLAS_TOL)
    assert not got[2].any()                 # seq_len 0 writes zeros
    # sharing is invisible: slot 1 equals the per-slot plain version on a
    # private copy of its blocks (batch 1 against 4: CPU matmuls may sum
    # in another order, so to 1e-6, the reference's own bar for this)
    view = lambda x: _t(np.concatenate([x[t] for t in tables[1]])[None])
    solo = TREF.paged_decode_attention_ref(_t(q[1:2]), view(k), view(v),
                                           _t(lens[1:2]), **kw)
    torch.testing.assert_close(got[1:2], solo, atol=1e-6, rtol=1e-6)


def _quantized(k, v):
    kq, ks = JQ.quantize_kv(jnp.asarray(k))
    vq, vs = JQ.quantize_kv(jnp.asarray(v))
    return [np.asarray(a) for a in (kq, ks, vq, vs)]


@pytest.mark.parametrize("shape,kw", POOL_CASES, ids=str)
def test_int8_refs_match_oracle_and_pallas(shape, kw):
    q, k, v, lens, tables = _pool_inputs(*shape, seed=4)
    kq, ks, vq, vs = _quantized(k, v)
    # per slot: the pool's first 4 blocks read as a (4, 2 * BS) cache
    S = 2 * BS
    sk, ss, sv, sd = (x[:8].reshape(4, S, *x.shape[2:]) for x in
                      (kq, ks, vq, vs))
    slens = np.minimum(lens, S).astype(np.int32)
    got = TREF.paged_decode_attention_ref(
        _t(q), _t(sk), _t(sv), _t(slens), k_scale=_t(ss), v_scale=_t(sd),
        **kw)
    want = JREF.paged_decode_attention_ref(
        jnp.asarray(q), JQ.dequantize_kv(jnp.asarray(sk), jnp.asarray(ss)),
        JQ.dequantize_kv(jnp.asarray(sv), jnp.asarray(sd)),
        jnp.asarray(slens), **kw)
    _close(got, want)
    _close(got, paged_decode_attention_kernel_call(
        jnp.asarray(q), jnp.asarray(sk), jnp.asarray(sv), jnp.asarray(slens),
        k_scale=jnp.asarray(ss), v_scale=jnp.asarray(sd), bk=BS,
        interpret=True, **kw), PALLAS_TOL)
    # pooled
    got = TREF.paged_decode_attention_bt_ref(
        _t(q), _t(kq), _t(vq), _t(lens), _t(tables), k_scale=_t(ks),
        v_scale=_t(vs), **kw)
    ja = [jnp.asarray(a) for a in (q, kq, ks, vq, vs, lens, tables)]
    want = JREF.paged_decode_attention_bt_ref(
        ja[0], JQ.dequantize_kv(ja[1], ja[2]), JQ.dequantize_kv(ja[3], ja[4]),
        ja[5], ja[6], **kw)
    _close(got, want)
    _close(got, paged_decode_attention_bt_kernel_call(
        ja[0], ja[1], ja[3], ja[5], ja[6], k_scale=ja[2], v_scale=ja[4],
        interpret=True, **kw), PALLAS_TOL)


def test_bt_ref_ignores_stale_pool_blocks():
    """Mirror of ``tests/test_decode_attention.py::TestBlockTableKernel::
    test_stale_pool_blocks_ignored`` on the port's plain version: unmapped
    blocks and lanes past each seq_len may hold anything."""
    rng = np.random.default_rng(23)
    q = _t(_arr(rng, 2, 2, 8))
    k, v = _t(_arr(rng, 8, 4, 2, 8)), _t(_arr(rng, 8, 4, 2, 8))
    tables = torch.tensor([[0, 1], [2, 3]], dtype=torch.int32)
    lens = torch.tensor([5, 7], dtype=torch.int32)
    out1 = TREF.paged_decode_attention_bt_ref(q, k, v, lens, tables)
    k2, v2 = k.clone(), v.clone()
    k2[4:], v2[4:] = 1e9, -1e9                 # unmapped blocks
    k2[1, 1:], v2[1, 1:] = 1e9, -1e9           # slot 0 lanes [5, 8)
    k2[3, 3:], v2[3, 3:] = 1e9, -1e9           # slot 1 lane 7
    out2 = TREF.paged_decode_attention_bt_ref(q, k2, v2, lens, tables)
    torch.testing.assert_close(out1, out2, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("qdtype", ["f32", "bf16"])
def test_ops_int8_on_cpu_matches_jax_xla_dispatch(qdtype):
    q, k, v, lens, tables = _pool_inputs(4, 2, 16, seed=5)
    kq, ks, vq, vs = _quantized(k, v)
    jq = jnp.asarray(q, jnp.bfloat16 if qdtype == "bf16" else jnp.float32)
    tq = _t(np.asarray(jq, np.float32)).to(
        torch.bfloat16 if qdtype == "bf16" else torch.float32)
    tol = BF16_TOL if qdtype == "bf16" else ATOL
    want = JOPS.paged_decode_attention_bt(
        jq, *map(jnp.asarray, (kq, vq, lens, tables)), k_scale=ks,
        v_scale=vs, impl="xla")
    got = TOPS.paged_decode_attention_bt(
        tq, _t(kq), _t(vq), _t(lens), _t(tables), k_scale=_t(ks),
        v_scale=_t(vs))
    assert got.dtype == tq.dtype
    _close(got, np.asarray(want, np.float32), tol)
    S = NB * BS // 4
    sk, ss, sv, sd = (x.reshape(4, S, *x.shape[2:]) for x in
                      (kq, ks, vq, vs))
    want = JOPS.paged_decode_attention(
        jq, jnp.asarray(sk), jnp.asarray(sv), jnp.asarray(lens),
        k_scale=jnp.asarray(ss), v_scale=jnp.asarray(sd), window=11,
        impl="xla")
    got = TOPS.paged_decode_attention(
        tq, _t(sk), _t(sv), _t(lens), k_scale=_t(ss), v_scale=_t(sd),
        window=11)
    _close(got, np.asarray(want, np.float32), tol)
    # without scales, ops on CPU tensors is the plain version
    assert torch.equal(
        TOPS.paged_decode_attention_bt(*map(_t, (q, k, v, lens, tables))),
        TREF.paged_decode_attention_bt_ref(*map(_t, (q, k, v, lens, tables))))


# ---------------------------------------------------------------------------
# Reduced olmo-1b over a pooled cache
# ---------------------------------------------------------------------------

PBS, PNB, PNBLK = 8, 24, 4         # block size, pool blocks, blocks a slot
CACHED = (11, 17, 6, 0)            # rows cached per slot; slot 3 unadmitted


@pytest.fixture(scope="module")
def model():
    """Reduced olmo-1b weights from JAX's init, the tied embedding scaled
    by 0.1 so the layers, not the input token, pick the next token (as
    ``tests/test_torch_serve.py``)."""
    jcfg = JREG.get_reduced("olmo-1b")
    p = jax.tree.map(np.asarray, JAPI.init_params(jcfg, jax.random.PRNGKey(0)))
    p["embed"] = p["embed"] * np.float32(0.1)
    return dict(jcfg=jcfg, tcfg=TREG.get_reduced("olmo-1b"),
                jp=jax.tree.map(jnp.asarray, p),
                tp=interop.params_from_numpy(p))


def _tables():
    """Slots 0 and 1 share their first block, slot 3 holds the sentinel
    PNB; the blocks come from a permutation of the pool."""
    perm = np.random.default_rng(7).permutation(PNB)
    t = perm[:4 * PNBLK].reshape(4, PNBLK).astype(np.int32)
    t[1, 0] = t[0, 0]
    t[3] = PNB
    return t


@pytest.fixture(scope="module")
def prompts():
    """One prompt per slot (CACHED[b] cached rows + the token decode feeds
    first); slot 1 starts with slot 0's first block of tokens."""
    rng = np.random.default_rng(8)
    ps = [rng.integers(0, 512, size=n + 1).astype(np.int32) for n in CACHED]
    ps[1][:PBS] = ps[0][:PBS]
    return ps


def _port_pool(model, prompts, garbage_seed=9):
    """The port's prefill of every prompt (right-padded, one batch) copied
    into a pool whose other rows hold bf16 garbage."""
    cfg = model["tcfg"]
    T = max(CACHED)
    toks = np.zeros((4, T), np.int32)
    for b, n in enumerate(CACHED):
        toks[b, :n] = prompts[b][:n]
    _, dense = TAPI.prefill(cfg, model["tp"], {"tokens": _t(toks)})
    pool = TAPI.init_kv_pool(cfg, PNB, PBS, device="cpu")
    gen = torch.Generator().manual_seed(garbage_seed)
    for x in (pool.k, pool.v):
        x.copy_(torch.randn(x.shape, generator=gen).to(x.dtype))
    fill_pool(pool, dense, CACHED, _tables())
    return pool


def _copy(c):
    return TTF.Cache(k=c.k.clone(), v=c.v.clone(), pos=c.pos.clone())


def _jax_cache(c):
    return JTF.Cache(k=jnp.asarray(c.k.float().numpy(), jnp.bfloat16),
                     v=jnp.asarray(c.v.float().numpy(), jnp.bfloat16),
                     pos=jnp.asarray(int(c.pos), jnp.int32))


def _feed(prompts):
    toks = np.array([p[-1] for p in prompts], np.int32)
    return toks, np.array(CACHED, np.int32)


def test_pooled_decode_step_matches_jax(model, prompts):
    """One pooled step (slot 2 frozen, slot 3 the sentinel, whose write is
    dropped) on the same pool and tables: logits and written rows within
    the serve bar, every other pool row bitwise unchanged on both sides."""
    pool = _port_pool(model, prompts)
    before = _copy(pool)
    toks, lens = _feed(prompts)
    active = np.array([True, True, False, False])
    tables = _tables()
    jstep = jax.jit(JTF.decode_step_paged, static_argnums=0)
    jl, jc, jlens = jstep(model["jcfg"], model["jp"], _jax_cache(pool),
                          jnp.asarray(toks), jnp.asarray(lens),
                          jnp.asarray(active), tables=jnp.asarray(tables))
    tl, tc, tlens = TTF.decode_step_paged(
        model["tcfg"], model["tp"], pool, _t(toks), _t(lens), _t(active),
        tables=_t(tables))
    jl = np.asarray(jl)
    np.testing.assert_allclose(tl.numpy(), jl, atol=LOGIT_REL_TOL *
                               np.abs(jl).max(), rtol=0)
    np.testing.assert_array_equal(tlens.numpy(), np.asarray(jlens))
    written = np.zeros((PNB, PBS), bool)
    for b in range(3):                     # slot 3's row is dropped
        written[tables[b, lens[b] // PBS], lens[b] % PBS] = True
    for name in ("k", "v"):
        got = getattr(tc, name).float().numpy()
        want = np.asarray(getattr(jc, name), np.float32)
        old = getattr(before, name).float().numpy()
        np.testing.assert_array_equal(got[:, ~written], old[:, ~written])
        np.testing.assert_array_equal(want[:, ~written], old[:, ~written])
        np.testing.assert_allclose(
            got[:, written], want[:, written], rtol=0,
            atol=LOGIT_REL_TOL * np.abs(want[:, written]).max())


def _jax_margin(model, prompt, out_tokens, i):
    """JAX top-2 logit margin (and tolerance) where token ``i`` of a slot's
    stream was chosen, teacher-forced over its prompt."""
    ctx = np.concatenate([prompt, np.asarray(out_tokens[:i], np.int32)])
    logits, _ = JTF.forward(model["jcfg"], model["jp"],
                            {"tokens": jnp.asarray(ctx)[None]})
    last = np.sort(np.asarray(logits[0, -1]))
    return float(last[-1] - last[-2]), LOGIT_REL_TOL * float(np.abs(last).max())


BUDGET = np.array([6, 4, 6, 0], np.int32)


def test_api_decode_n_pooled_matches_jax(model, prompts):
    pool = _port_pool(model, prompts)
    toks, lens = _feed(prompts)
    tables = _tables()
    jdec = jax.jit(functools.partial(JAPI.decode_n, num_steps=6),
                   static_argnums=0)
    jt, jc, jlens, _ = jdec(model["jcfg"], model["jp"], _jax_cache(pool),
                            jnp.asarray(toks), jnp.asarray(lens),
                            jnp.asarray(BUDGET), tables=jnp.asarray(tables))
    tt, tc, tlens, _ = TAPI.decode_n(
        model["tcfg"], model["tp"], pool, _t(toks), _t(lens), _t(BUDGET),
        num_steps=6, tables=_t(tables))
    np.testing.assert_array_equal(tlens.numpy(), np.asarray(jlens))
    jt, tt = np.asarray(jt).T, tt.numpy().T
    for b in range(3):
        diff = np.nonzero(jt[b] != tt[b])[0]
        if not len(diff):
            continue
        i = int(diff[0])
        margin, tol = _jax_margin(model, prompts[b], list(jt[b]), i)
        assert margin < tol, (
            f"slot {b}: token {i} differs (jax {jt[b, i]}, port {tt[b, i]}) "
            f"with a JAX top-2 margin {margin:.4f} >= tolerance {tol:.4f}")
        warnings.warn(f"slot {b}: streams part at token {i}, a near tie "
                      f"(JAX top-2 margin {margin:.4f} < {tol:.4f})")
    assert (tt[3] == toks[3]).all()           # unadmitted: repeats its token


# -- the port's own invariants, bitwise --------------------------------------


def _decode_pooled(model, pool, prompts, budget, steps):
    toks, lens = _feed(prompts)
    return TAPI.decode_n(model["tcfg"], model["tp"], pool, _t(toks),
                         _t(lens), _t(budget), num_steps=steps,
                         tables=_t(_tables()))


def test_decode_n_pooled_is_dense_decode_on_the_gathered_view(model,
                                                               prompts):
    """Slot 2 runs past the view's last lane (rows clamp, the last write
    wins); slot 1 freezes after 4 of 6 steps; slot 3 is unadmitted."""
    pool = _port_pool(model, prompts)
    tables = _tables()
    view = TTF.pool_view(_copy(pool), _t(tables))
    W = PNBLK * PBS
    toks, lens = _feed(prompts)
    lens[2] = W - 3
    budget = np.array([6, 4, 6, 0], np.int32)
    dt, dc, dlens, dlast = TAPI.decode_n(
        model["tcfg"], model["tp"], view, _t(toks), _t(lens), _t(budget),
        num_steps=6)
    pt, pc, plens, plast = TAPI.decode_n(
        model["tcfg"], model["tp"], pool, _t(toks), _t(lens), _t(budget),
        num_steps=6, tables=_t(tables))
    assert pc is pool
    for a, b in ((dt, pt), (dlens, plens), (dlast, plast)):
        assert torch.equal(a, b)
    # the pool's view now holds what the dense decode wrote, slot by slot
    # over the rows it decoded
    after = TTF.pool_view(_copy(pool), _t(tables))
    for b in range(3):
        rows = slice(0, int(dlens[b]))
        for x, y in ((after.k, dc.k), (after.v, dc.v)):
            assert torch.equal(x[:, b, rows], y[:, b, rows])


def test_pooled_step_loop_writes_what_decode_n_writes(model, prompts):
    """Budgets >= num_steps for the admitted slots: a greedy loop of pooled
    steps (kernel 3's path) gives decode_n(tables=)'s tokens and pool; the
    shared block and every block no slot decodes into are unchanged."""
    start = _port_pool(model, prompts)
    steps = 5
    budget = np.array([5, 5, 5, 0], np.int32)
    tables = _tables()
    toks, lens = _feed(prompts)
    pool = _copy(start)
    tk, ln = _t(toks), _t(lens)
    produced = torch.zeros(4, dtype=torch.int32)
    out = []
    for _ in range(steps):
        active = produced < _t(budget)
        logits, pool, ln = TTF.decode_step_paged(
            model["tcfg"], model["tp"], pool, tk, ln, active,
            tables=_t(tables))
        tk = torch.where(active, torch.argmax(logits, -1).to(torch.int32),
                         tk)
        produced += active.to(torch.int32)
        out.append(tk)
    dt, dc, dlens, _ = _decode_pooled(model, _copy(start), prompts, budget,
                                      steps)
    assert torch.equal(torch.stack(out), dt) and torch.equal(ln, dlens)
    assert torch.equal(pool.k, dc.k) and torch.equal(pool.v, dc.v)
    decoded = {int(tables[b, r // PBS]) for b in range(3)
               for r in range(lens[b], lens[b] + steps)}
    assert int(tables[0, 0]) not in decoded   # the shared block
    keep = [blk for blk in range(PNB) if blk not in decoded]
    assert torch.equal(dc.k[:, keep], start.k[:, keep])
    assert torch.equal(dc.v[:, keep], start.v[:, keep])


def test_decode_n_pooled_is_chunk_invariant(model, prompts):
    start = _port_pool(model, prompts)
    budget = np.array([4, 3, 4, 0], np.int32)
    whole = _decode_pooled(model, _copy(start), prompts, budget, 4)
    toks, lens = _feed(prompts)
    tables = _t(_tables())
    pool = _copy(start)
    t1, pool, l1, last = TAPI.decode_n(
        model["tcfg"], model["tp"], pool, _t(toks), _t(lens), _t(budget),
        num_steps=1, tables=tables)
    t3, pool, l3, _ = TAPI.decode_n(
        model["tcfg"], model["tp"], pool, last, l1,
        _t(budget) - torch.minimum(_t(budget), torch.tensor(1)),
        num_steps=3, tables=tables)
    assert torch.equal(torch.cat([t1, t3]), whole[0])
    assert torch.equal(l3, whole[2])
    assert torch.equal(pool.k, whole[1].k) and torch.equal(pool.v,
                                                           whole[1].v)


def test_init_kv_pool_layout_and_dense_only():
    cfg = TREG.get_reduced("olmo-1b")
    pool = TAPI.init_kv_pool(cfg, 5, 4, device="cpu")
    assert tuple(pool.k.shape) == (3, 5, 4, 4, 16)
    assert pool.k.dtype == torch.bfloat16 and not pool.v.any()
    with pytest.raises(NotImplementedError):
        TAPI.init_kv_pool(TREG.get_reduced("dlrm0"), 5, 4, device="cpu")
