"""The port's int8 weight storage (``models/quant.py``'s ``quantize_params``
and ``SliceSpec(quant="int8")``) on reduced olmo-1b, against the JAX
package and against itself.

  * ``quantize_params`` picks the same leaves as JAX's and gives the same
    bits (int8 values, f32 scales, tiles), leaf by leaf; ``storage_bytes``
    agrees on the full and the quantised tree; ``interop`` carries JAX's
    quantised tree over with the same bits.
  * ``cast`` / ``take`` of a ``QTensor``: ``take`` equals the rows of the
    whole table dequantised; both equal the reference's, a stacked weight
    and a whole-row tile included.
  * Bitwise, within the port: prefill and decode logits and the engine's
    greedy streams of the quantised tree equal those of its
    ``dequantize_params`` tree (int8 is a storage change, not an
    approximation).
  * The port's ``quant="int8"`` engine against JAX's, on JAX's quantised
    tree carried over by ``interop``: greedy streams token for token except
    at a JAX near tie (reported), as ``tests/test_torch_serve.py`` holds
    them (LOGIT_REL_TOL = 2^-5 of the largest |logit|), and
    ``weight_stream_bytes`` equal.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as JREG
from repro.models import api as JAPI
from repro.models import quant as JQ
from repro.models import transformer as JTF
from repro.serve.engine import ServeEngine as JEngine
from repro.serve.engine import SliceSpec as JSpec
from repro_torch import interop
from repro_torch.configs import registry as TREG
from repro_torch.models import api as TAPI
from repro_torch.models import quant as TQ
from repro_torch.models import transformer as TTF
from repro_torch.serve.engine import ServeEngine as TEngine
from repro_torch.serve.engine import SliceSpec as TSpec

LOGIT_REL_TOL = 2.0 ** -5
SPEC = dict(slots=2, max_len=48, prompt_len=16, chunk=4, quant="int8")
PROMPT_LENS = (5, 16, 9)
BUDGETS = (8, 5, 6)


@pytest.fixture(scope="module")
def model():
    """Reduced olmo-1b from JAX's init, the tied embedding shrunk by 0.1 so
    the streams do not just repeat one token."""
    cfg = JREG.get_reduced("olmo-1b")
    p = jax.tree.map(np.asarray, JAPI.init_params(cfg, jax.random.PRNGKey(0)))
    p["embed"] = p["embed"] * np.float32(0.1)
    jp = jax.tree.map(jnp.asarray, p)
    jq = JQ.quantize_params(cfg, jp)
    return dict(jcfg=cfg, tcfg=TREG.get_reduced("olmo-1b"), jp=jp, jq=jq,
                tp=interop.params_from_numpy(p),
                tq_jax=interop.params_from_numpy(
                    jax.tree.map(np.asarray, jq)))


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    else:
        yield path, tree


def _jleaves(tree):
    is_q = lambda x: isinstance(x, JQ.QTensor)
    flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_q)[0]
    return {"/" + JQ._path_str(p): x for p, x in flat}


def test_quantize_params_matches_jax_leaf_by_leaf(model):
    got = dict(_leaves(TQ.quantize_params(model["tcfg"], model["tp"])))
    want = _jleaves(model["jq"])
    assert set(got) == set(want)
    n_q = 0
    for path, w in want.items():
        g = got[path]
        if isinstance(w, JQ.QTensor):
            n_q += 1
            assert isinstance(g, TQ.QTensor), path
            assert g.tile == w.tile and g.q.dtype == torch.int8
            np.testing.assert_array_equal(g.q.numpy(), np.asarray(w.q))
            np.testing.assert_array_equal(g.scale.numpy(),
                                          np.asarray(w.scale))
        else:
            assert not isinstance(g, TQ.QTensor), path
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert n_q >= 5
    # the carried-over JAX tree holds the same bits
    for path, g in _leaves(model["tq_jax"]):
        h = got[path]
        pair = ((g.q, h.q), (g.scale, h.scale)) if isinstance(
            g, TQ.QTensor) else ((g, h),)
        assert all(torch.equal(a, b) for a, b in pair), path


def test_storage_bytes_match_jax(model):
    tq = TQ.quantize_params(model["tcfg"], model["tp"])
    assert TQ.storage_bytes(model["tp"]) == JQ.storage_bytes(model["jp"])
    assert TQ.storage_bytes(tq) == JQ.storage_bytes(model["jq"])
    assert TQ.storage_bytes(model["tp"]) / TQ.storage_bytes(tq) >= 1.8


@pytest.mark.parametrize("shape", [(32, 128), (3, 32, 256), (32, 200)],
                         ids=["table", "stacked", "whole-row-tile"])
def test_take_and_cast_match_reference(shape):
    rng = np.random.default_rng(0)
    w = rng.standard_normal(shape).astype(np.float32)
    tq, jq = TQ.quantize(torch.from_numpy(w)), JQ.quantize(jnp.asarray(w))
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        np.testing.assert_array_equal(
            TQ.cast(tq, dt).float().numpy(),
            np.asarray(JQ.cast(jq, jdt).astype(jnp.float32)))
    ids = np.array([3, 3, 0, 31])
    if len(shape) == 2:
        got = TQ.take(tq, torch.from_numpy(ids), torch.float32)
        assert torch.equal(got, tq.dequant(torch.float32)[ids])
        np.testing.assert_array_equal(
            got.numpy(),
            np.asarray(JQ.take(jq, jnp.asarray(ids), jnp.float32)))


def test_forward_bitwise_vs_dequantized(model):
    """Prefill, then decode steps over the cache: the quantised tree and
    its dequantised tree give the same logits, bit for bit."""
    cfg = model["tcfg"]
    qp = TQ.quantize_params(cfg, model["tp"])
    mat = TQ.dequantize_params(qp)
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, 512,
                                                              (2, 12)))
    outs = []
    for p in (qp, mat):
        logits, cache = TAPI.prefill(cfg, p, {"tokens": toks}, max_len=20)
        lens = torch.full((2,), 12, dtype=torch.int32)
        steps = [logits]
        for t in range(3):
            lg, cache, lens = TTF.decode_step_paged(
                cfg, p, cache, toks[:, t], lens, torch.ones(2, dtype=bool))
            steps.append(lg)
        outs.append(steps)
    for a, b in zip(*outs):
        assert torch.equal(a, b)


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.default_rng(0)
    return [rng.integers(0, 512, size=n).astype(np.int32)
            for n in PROMPT_LENS]


def _serve(engine, prompts):
    reqs = [engine.submit(p, max_new_tokens=m)
            for p, m in zip(prompts, BUDGETS)]
    engine.run()
    assert all(r.done for r in reqs)
    return [list(r.out_tokens) for r in reqs]


@pytest.fixture(scope="module")
def port_int8(model, prompts):
    eng = TEngine(model["tcfg"], model["tp"], TSpec(**SPEC), device="cpu")
    return eng, _serve(eng, prompts)


def test_int8_engine_bitwise_vs_dequantized_tree(model, prompts, port_int8):
    eng, streams = port_int8
    mat = TQ.dequantize_params(eng.params)
    dense = TEngine(model["tcfg"], mat, TSpec(**{**SPEC, "quant": "none"}),
                    device="cpu")
    assert _serve(dense, prompts) == streams
    # a tree quantised already (JAX's, carried over) is served as it is
    again = TEngine(model["tcfg"], model["tq_jax"], TSpec(**SPEC),
                    device="cpu")
    assert _serve(again, prompts) == streams


def _jax_margin(model, prompt, out_tokens, i):
    pad = np.zeros((SPEC["prompt_len"],), np.int32)
    seq = prompt[-SPEC["prompt_len"]:]
    pad[-len(seq):] = seq
    ctx = np.concatenate([pad, np.asarray(out_tokens[:i], np.int32)])
    logits, _ = JTF.forward(model["jcfg"], model["jq"],
                            {"tokens": jnp.asarray(ctx)[None]})
    last = np.sort(np.asarray(logits[0, -1]))
    return float(last[-1] - last[-2]), LOGIT_REL_TOL * float(
        np.abs(last).max())


def test_int8_engine_matches_jax(model, prompts, port_int8):
    jeng = JEngine(model["jcfg"], model["jp"], JSpec(**SPEC))
    js = _serve(jeng, prompts)
    eng, ts = port_int8
    for r, (a, b) in enumerate(zip(js, ts)):
        assert len(a) == len(b) == BUDGETS[r]
        diff = [i for i, (x, y) in enumerate(zip(a, b)) if x != y]
        if diff:
            margin, tol = _jax_margin(model, prompts[r], a, diff[0])
            assert margin < tol, (r, diff[0], a, b, margin, tol)
            warnings.warn(f"request {r}: streams part at token {diff[0]}, "
                          f"a near tie ({margin:.4f} < {tol:.4f})")
    assert eng.weight_stream_bytes() == jeng.weight_stream_bytes()
    assert eng.kv_stats() == jeng.kv_stats()
