"""The port's MoE layer (``repro_torch.models.moe``) against the JAX
package's ``repro.models.moe``, on the reduced qwen3-moe and kimi-k2.

Same weights on both sides (JAX's ``moe_init``, handed over through
numpy), same inputs from a numpy seed, rounded to bf16 once.

Tolerances.  The router's indices and the dropped fraction must equal
JAX's exactly, and the dispatch buffer and the combine (given the same
expert outputs) bitwise: they are index arithmetic and a fixed order of
bf16 adds.  The expert products are bf16 matmuls that the two frameworks
round at slightly different places, so an output is held within
OUT_TOL = 2**-5 * max|out| (8 bf16 ulps at the largest value); gates and
the aux loss, f32 softmax reductions, within 1e-6.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as JREG
from repro.models import api as JAPI
from repro.models import moe as JM
from repro.parallel.context import LOCAL
from repro_torch import interop
from repro_torch.configs import registry as TREG
from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.models import api as TAPI
from repro_torch.models import layers as TL
from repro_torch.models import moe as TM
from repro_torch.parallel.context import ParallelContext

ARCHS = ("qwen3-moe-30b-a3b", "kimi-k2-1t-a32b")
OUT_REL_TOL = 2.0 ** -5
F32_TOL = 1e-6


def _bf16(x: np.ndarray):
    """The same bf16 values on both sides: (jax array, torch tensor)."""
    j = jnp.asarray(x, jnp.float32).astype(jnp.bfloat16)
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        torch.bfloat16)
    return j, t


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, what=""):
    want = _np(want)
    np.testing.assert_allclose(_np(got), want, rtol=0,
                               atol=OUT_REL_TOL * float(np.abs(want).max()),
                               err_msg=what)


@pytest.fixture(scope="module", params=ARCHS)
def layer(request):
    jcfg = JREG.get_reduced(request.param)
    p = jax.tree.map(np.asarray, JM.moe_init(jcfg, jax.random.PRNGKey(0)))
    return dict(jcfg=jcfg, tcfg=TREG.get_reduced(request.param), jp=p,
                tp=interop.params_from_numpy(p))


def _x(n, d, seed, scale=1.0):
    return np.random.default_rng(seed).standard_normal((n, d)) * scale


# ---------------------------------------------------------------------------
# Config copies
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("getter", ["get_config", "get_reduced"])
def test_moe_config_copies_match_reference(arch, getter):
    t = getattr(TREG, getter)(arch)
    j = getattr(JREG, getter)(arch)
    for f in dataclasses.fields(ModelConfig):
        if f.name in ("attention", "moe"):
            continue
        assert getattr(t, f.name) == getattr(j, f.name), f.name
    assert dataclasses.asdict(t.attention) == dataclasses.asdict(j.attention)
    assert dataclasses.asdict(t.moe) == dataclasses.asdict(j.moe)


# ---------------------------------------------------------------------------
# Router
# ---------------------------------------------------------------------------

def test_router_topk_matches_jax(layer):
    jx, tx = _bf16(_x(64, layer["jcfg"].d_model, 1))
    jg, je, ja = JM.router_topk(layer["jcfg"], layer["jp"], jx)
    tg, te, ta = TM.router_topk(layer["tcfg"], layer["tp"], tx)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=0,
                               atol=F32_TOL)
    np.testing.assert_allclose(float(ta), float(ja), rtol=F32_TOL)
    np.testing.assert_allclose(tg.sum(-1).numpy(), 1.0, rtol=1e-4)


def test_router_ties_go_to_the_lower_expert(layer):
    """Exactly tied bf16 logits: router columns 2, 5 and 6 are equal and
    lead every token (positive inputs, a large positive column), so each
    token ties those three experts bit for bit and top-k must choose among
    them.  JAX's ``top_k`` takes the lower index first: experts 2 then 5;
    the port must choose the same."""
    cfg = layer["jcfg"]
    k = cfg.moe.top_k
    assert k < 3
    d = cfg.d_model
    r = np.asarray(layer["jp"]["router"]).copy()
    r[:, 2] = 3.0 / np.sqrt(d)
    r[:, 5] = r[:, 6] = r[:, 2]
    jx, tx = _bf16(np.abs(_x(32, d, 2)) + 0.1)
    jg, je, _ = JM.router_topk(cfg, {"router": jnp.asarray(r)}, jx)
    tg, te, _ = TM.router_topk(layer["tcfg"], {"router": torch.from_numpy(r)},
                               tx)
    je, jg = np.asarray(je), np.asarray(jg)
    assert (jg[:, 0] == jg[:, -1]).all()            # the tie is exact
    np.testing.assert_array_equal(je, np.tile([2, 5][:k], (32, 1)))
    np.testing.assert_array_equal(te.numpy(), je)
    np.testing.assert_allclose(tg.numpy(), jg, rtol=0, atol=F32_TOL)


def test_router_softcap_follows_jax(layer):
    cfg = dataclasses.replace(layer["jcfg"], moe=dataclasses.replace(
        layer["jcfg"].moe, router_softcap=0.5))
    tcfg = dataclasses.replace(layer["tcfg"], moe=dataclasses.replace(
        layer["tcfg"].moe, router_softcap=0.5))
    jx, tx = _bf16(_x(48, cfg.d_model, 3))
    jg, je, ja = JM.router_topk(cfg, layer["jp"], jx)
    tg, te, ta = TM.router_topk(tcfg, layer["tp"], tx)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=0,
                               atol=F32_TOL)
    np.testing.assert_allclose(float(ta), float(ja), rtol=F32_TOL)


# ---------------------------------------------------------------------------
# Dispatch and combine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("capacity", [4, 7, 40])
def test_dispatch_and_combine_are_bitwise_jax(layer, capacity):
    """Given the same routing and the same expert outputs, the buffer and
    the combined output equal JAX's bit for bit: the combine adds each
    token's gated bf16 contributions in ascending expert order."""
    cfg = layer["jcfg"]
    E = cfg.moe.num_experts
    jx, tx = _bf16(_x(64, cfg.d_model, 4))
    jg, je, _ = JM.router_topk(cfg, layer["jp"], jx)
    jbuf, jcomb, jd = JM._dispatch_sorted(jx, jg, je, E, capacity)
    tbuf, tcomb, td = TM._dispatch_sorted(
        tx, torch.from_numpy(np.asarray(jg)),
        torch.from_numpy(np.asarray(je)).long(), E, capacity)
    np.testing.assert_array_equal(_np(tbuf), _np(jbuf))
    assert float(td) == float(jd)
    jy, ty = _bf16(np.random.default_rng(5).standard_normal(
        (E, capacity, cfg.d_model)))
    out = tcomb(ty)
    assert out.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(out), _np(jcomb(jy)))


def _dense_oracle(cfg, p, x):
    """The reference's oracle (``tests/test_moe.py``): every expert on every
    token in f32, weighted by the renormalised top-k gates."""
    gates, eidx, _ = JM.router_topk(cfg, p, x, jnp.float32)
    m = cfg.moe
    outs = []
    for e in range(m.num_experts):
        g = x @ p["wg"][e]
        u = x @ p["wu"][e]
        outs.append((jax.nn.silu(g) * u) @ p["wo"][e])
    stack = jnp.stack(outs, axis=1)                      # (S, E, D)
    sel = jnp.zeros((x.shape[0], m.num_experts))
    for j in range(m.top_k):
        sel = sel + jax.nn.one_hot(eidx[:, j], m.num_experts) * gates[:, j:j + 1]
    out = jnp.einsum("se,sed->sd", sel, stack)
    if m.num_shared_experts:
        out = out + JM._shared_expert(cfg, p["shared"], x, jnp.float32)
    return out


def test_moe_local_matches_dense_oracle_at_high_capacity(layer):
    x = _x(16, layer["jcfg"].d_model, 6, scale=0.5)
    jx, tx = _bf16(x)
    got, aux, dropped = TM.moe_local(layer["tcfg"], layer["tp"], tx,
                                     capacity_factor=8.0)
    _, _, jd = JM.moe_local(layer["jcfg"], layer["jp"], jx,
                            capacity_factor=8.0)
    assert float(dropped) == float(jd) == 0.0
    want = _dense_oracle(layer["jcfg"], layer["jp"], jnp.asarray(_np(tx)))
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want),
                               rtol=8e-2, atol=8e-2)


@pytest.mark.parametrize("factor", [0.25, 1.0, 1.25, 2.0])
def test_moe_local_matches_jax(layer, factor):
    """Outputs within OUT_TOL, dropped fraction and aux as JAX's."""
    jx, tx = _bf16(_x(64, layer["jcfg"].d_model, 7))
    jo, ja, jd = JM.moe_local(layer["jcfg"], layer["jp"], jx,
                              capacity_factor=factor)
    to, ta, td = TM.moe_local(layer["tcfg"], layer["tp"], tx,
                              capacity_factor=factor)
    assert to.dtype == torch.bfloat16 and to.shape == (64, jx.shape[1])
    _close(to, jo, f"factor {factor}")
    assert float(td) == float(jd)
    np.testing.assert_allclose(float(ta), float(ja), rtol=F32_TOL)
    if factor == 0.25:
        assert float(td) > 0


def test_f32_inputs_promote_as_jax(layer):
    """An f32 input with bf16 weights computes in f32, as JAX promotes."""
    x = _x(32, layer["jcfg"].d_model, 8).astype(np.float32)
    jo, _, jd = JM.moe_local(layer["jcfg"], layer["jp"], jnp.asarray(x))
    to, _, td = TM.moe_local(layer["tcfg"], layer["tp"], torch.from_numpy(x))
    assert to.dtype == torch.float32
    _close(to, jo)
    assert float(td) == float(jd)


def test_dropping_increases_with_lower_capacity(layer):
    _, tx = _bf16(_x(64, layer["jcfg"].d_model, 3))
    drops = [float(TM.moe_local(layer["tcfg"], layer["tp"], tx,
                                capacity_factor=cf)[2])
             for cf in (4.0, 1.0, 0.25)]
    assert drops[0] <= drops[1] <= drops[2]
    assert drops[2] > 0


def test_capacity_formula():
    m = MoEConfig(num_experts=8, top_k=2, expert_ffw=4)
    assert TM.capacity_for(64, m, 1.0) == 16
    assert TM.capacity_for(64, m, 1.25) == 20
    assert TM.capacity_for(1, m, 1.0) == 4      # floor
    full = TREG.get_config("qwen3-moe-30b-a3b").moe
    for tokens, f in ((8, 2.0), (1024, 1.25), (8 * 128, 1.25), (3, 2.0)):
        assert TM.capacity_for(tokens, full, f) == JM.capacity_for(
            tokens, JREG.get_config("qwen3-moe-30b-a3b").moe, f)


def test_shared_expert_matches_jax():
    jcfg = JREG.get_reduced("kimi-k2-1t-a32b")
    p = jax.tree.map(np.asarray, JM.moe_init(jcfg, jax.random.PRNGKey(1)))
    assert "shared" in p
    tp = interop.params_from_numpy(p)
    jx, tx = _bf16(_x(24, jcfg.d_model, 9))
    _close(TM._shared_expert(TREG.get_reduced("kimi-k2-1t-a32b"),
                             tp["shared"], tx),
           JM._shared_expert(jcfg, p["shared"], jx))


@pytest.mark.parametrize("fn,factor", [("moe_ep", 1.25),
                                       ("moe_decode", 2.0)])
def test_one_device_entry_points_are_moe_local(layer, fn, factor):
    """``moe_ep`` and ``moe_decode`` on one device: ``moe_local`` over the
    B x T tokens at 1.25 and 2.0, as the reference's branch; the same
    outputs as JAX's entry point.  With a mesh they name item 12."""
    jx, tx = _bf16(_x(12, layer["jcfg"].d_model, 10))
    T = 3 if fn == "moe_ep" else 1
    tx3 = tx.reshape(12 // T, T, -1)
    got, aux, dropped = getattr(TM, fn)(layer["tcfg"], layer["tp"], tx3)
    want, waux, wd = TM.moe_local(layer["tcfg"], layer["tp"], tx,
                                  capacity_factor=factor)
    assert torch.equal(got.reshape(12, -1), want)
    assert float(aux) == float(waux) and float(dropped) == float(wd)
    kw = (dict(batch_spec=None, seq_spec=None) if fn == "moe_ep"
          else dict(batch_spec=None))
    jo, _, jd = getattr(JM, fn)(layer["jcfg"], layer["jp"],
                                jx.reshape(12 // T, T, -1), LOCAL, **kw)
    _close(got, jo)
    assert float(dropped) == float(jd)

    class Mesh(ParallelContext):
        @property
        def has_mesh(self):
            return True

    with pytest.raises(NotImplementedError, match="item 12"):
        getattr(TM, fn)(layer["tcfg"], layer["tp"], tx3, Mesh())


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------

def _shapes(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_shapes(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_shapes(v, f"{prefix}/{i}"))
        return out
    return {prefix: (tuple(tree.shape), str(tree.dtype).removeprefix(
        "torch."))}


@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_tree_shapes_equal_jax(arch):
    """``api.param_shapes`` (meta tensors, f32 as the reference inits)
    equals ``jax.eval_shape`` of the reference's ``init_params`` leaf by
    leaf, the kimi-k2 dense prefix included."""
    tree = TAPI.param_shapes(TREG.get_config(arch), dtype=torch.float32)
    jtree = jax.eval_shape(lambda k: JAPI.init_params(JREG.get_config(arch),
                                                      k),
                           jax.random.PRNGKey(0))
    want = _shapes(jtree)
    assert _shapes(tree) == want
    n = sum(int(np.prod(s)) for s, _ in want.values())
    if arch == "qwen3-moe-30b-a3b":
        assert 30.5e9 < n < 30.6e9


@pytest.mark.parametrize("arch", ARCHS)
def test_init_draws_the_reference_distributions(arch):
    """The port's own init (a torch generator): the reference's layout and
    scale, truncated normal / sqrt(input width) for every expert matrix."""
    cfg = TREG.get_reduced(arch)
    p = TAPI.init_params(cfg, seed=0, device="cpu", dtype=torch.float32)
    moe = p["layers"]["moe"]
    for name, fan_in in (("router", cfg.d_model), ("wg", cfg.d_model),
                         ("wu", cfg.d_model), ("wo", cfg.moe.expert_ffw)):
        w = moe[name] * fan_in ** 0.5
        assert float(w.abs().max()) <= 2.0
        assert abs(float(w.std()) - 0.8796) < 0.05, name  # std on [-2, 2]
    if cfg.moe.dense_layers:
        assert len(p["dense_prefix"]) == cfg.moe.dense_layers
        assert p["dense_prefix"][0]["mlp"]["wg"].shape == (
            cfg.d_model, cfg.moe.dense_ffw)


def test_trunc_normal_draws_large_leaves_in_chunks(monkeypatch):
    """A leaf over ``INIT_CHUNK`` elements is drawn chunk by chunk straight
    into its storage dtype: same shape, dtype and distribution."""
    gen = torch.Generator().manual_seed(0)
    whole = TL.trunc_normal(gen, (64, 100), 16, "cpu", torch.bfloat16)
    monkeypatch.setattr(TL, "INIT_CHUNK", 999)
    chunked = TL.trunc_normal(gen, (64, 100), 16, "cpu", torch.bfloat16)
    assert chunked.shape == whole.shape and chunked.dtype == torch.bfloat16
    for w in (whole, chunked):
        w = w.float() * 4.0
        assert float(w.abs().max()) <= 2.0
        assert abs(float(w.std()) - 0.8796) < 0.05
    assert not torch.equal(chunked, whole)
