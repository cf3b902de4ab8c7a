"""The port's SSD block (``repro_torch.models.ssm``) against the reference's
(``repro.models.ssm``), on reduced mamba2-130m (H = 8 heads of P = 16,
state N = 16, chunk 16).

Same numpy-seeded weights and inputs on both sides; the JAX side is jitted.
Tolerances, stated per test:
  * ``ssd_reference`` is f32 end to end: within REF_RTOL = 1e-5 of the
    largest |value| (the two frameworks sum in other orders);
  * the bf16 paths (``ssd_forward``, ``ssd_step``): outputs within
    OUT_TOL = 2^-5 of the largest |out| (8 bf16 ulps there), states within
    STATE_TOL = 2^-7 of the largest |state| (the state is f32, fed by bf16
    projections that can round the other way);
  * the raw conv tail is bf16 of a bf16 projection: within 2^-7 of its
    largest |value|.
T in {1, 7, 16, 37} with chunk 16: 7 and 37 are padded (dt masked on the
pad), 1 takes Q = T, 37 passes state across three chunks.

Then the four properties of ``tests/test_ssm.py`` within the port, at the
reference test's own tolerances (5e-2, 6e-2 for the continuation).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as JREG
from repro.models import ssm as JSSM
from repro_torch.configs import registry as TREG
from repro_torch.models import ssm as TSSM

REF_RTOL = 1e-5
OUT_TOL = 2.0 ** -5
STATE_TOL = 2.0 ** -7
SHAPES = [(B, T) for B in (1, 2) for T in (1, 7, 16, 37)]


@pytest.fixture(scope="module")
def cfgs():
    return JREG.get_reduced("mamba2-130m"), TREG.get_reduced("mamba2-130m")


def _np_params(cfg, seed=0):
    """f32 weights of one SSD block from a numpy generator: the reference's
    shapes and init scales, with the zero/one leaves perturbed so that each
    one counts."""
    rng = np.random.default_rng(seed)
    d = cfg.d_model
    DI, H, P, N = TSSM.ssm_dims(cfg)
    W = cfg.ssm.conv_width
    f = np.float32
    dt = np.exp(np.linspace(np.log(1e-3), np.log(1e-1), H))
    return {
        "in_proj": (rng.standard_normal((d, 2 * DI + 2 * N + H))
                    / np.sqrt(d)).astype(f),
        "conv_w": (rng.standard_normal((W, DI + 2 * N)) / np.sqrt(W)).astype(f),
        "conv_b": (0.1 * rng.standard_normal(DI + 2 * N)).astype(f),
        "A_log": np.log(np.linspace(1.0, 16.0, H)).astype(f),
        "D": (1.0 + 0.1 * rng.standard_normal(H)).astype(f),
        "dt_bias": np.log(np.expm1(dt)).astype(f),
        "norm_w": (0.1 * rng.standard_normal(DI)).astype(f),
        "out_proj": (rng.standard_normal((DI, d)) / np.sqrt(DI)).astype(f),
    }


@pytest.fixture(scope="module")
def params(cfgs):
    p = _np_params(cfgs[0])
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: torch.from_numpy(v) for k, v in p.items()})


def _u(cfg, B, T, seed=1, scale=0.5):
    return (scale * np.random.default_rng(seed).standard_normal(
        (B, T, cfg.d_model))).astype(np.float32)


def _bf16(x: np.ndarray):
    return jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).bfloat16()


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, rel, what):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, what
    tol = rel * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=what)


_jref = jax.jit(JSSM.ssd_reference, static_argnums=0)
_jfwd = jax.jit(JSSM.ssd_forward, static_argnums=0)
_jstep = jax.jit(JSSM.ssd_step, static_argnums=0)


# ---------------------------------------------------------------------------
# Against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stacked", [None, 3])
def test_init_matches_reference_shapes_and_formulas(cfgs, stacked):
    """Shapes and dtypes of ``jax.eval_shape(ssd_init)``; the deterministic
    leaves equal the reference's values within 1 f32 ulp (numpy's and XLA's
    log); the truncated-normal leaves lie in [-2, 2] / sqrt(fan_in)."""
    jcfg, tcfg = cfgs
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda k: JSSM.ssd_init(jcfg, k, stacked=stacked),
                            key)
    jp = JSSM.ssd_init(jcfg, key, stacked=stacked)
    tp = TSSM.ssd_init(tcfg, torch.Generator().manual_seed(0),
                       stacked=stacked, device="cpu", dtype=torch.float32)
    assert tp.keys() == shapes.keys()
    for k, s in shapes.items():
        assert tuple(tp[k].shape) == s.shape, k
        assert tp[k].dtype == torch.float32, k
    for k in ("conv_b", "A_log", "D", "dt_bias", "norm_w"):
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=2 ** -23, atol=0, err_msg=k)
    fan = {"in_proj": tcfg.d_model, "conv_w": tcfg.ssm.conv_width,
           "out_proj": TSSM.ssm_dims(tcfg)[0]}
    for k, n in fan.items():
        x = tp[k].numpy() * np.sqrt(n)
        assert np.abs(x).max() <= 2.0 + 1e-6, k
        assert 0.75 < x.std() < 1.0, k          # ~0.88 for [-2, 2]
    bf = TSSM.ssd_init(tcfg, torch.Generator().manual_seed(0), stacked=stacked,
                       device="cpu")
    assert {k for k, v in bf.items() if v.dtype == torch.bfloat16} == {
        "in_proj", "out_proj"}


@pytest.mark.parametrize("B,T", SHAPES)
def test_ssd_reference_matches_jax(cfgs, params, B, T):
    """f32 oracle vs f32 oracle: out and final state within REF_RTOL of
    their largest |value|."""
    jcfg, tcfg = cfgs
    u = _u(tcfg, B, T)
    want, wstate = _jref(jcfg, params[0], jnp.asarray(u))
    got, gstate = TSSM.ssd_reference(tcfg, params[1], torch.from_numpy(u))
    assert got.dtype == gstate.dtype == torch.float32
    _close(got, want, REF_RTOL, "out")
    _close(gstate, wstate, REF_RTOL, "state")


@pytest.mark.parametrize("with_init", [False, True])
@pytest.mark.parametrize("B,T", SHAPES)
def test_ssd_forward_matches_jax(cfgs, params, B, T, with_init):
    """bf16 chunked forward: out within OUT_TOL, final state within
    STATE_TOL, the raw conv tail within 2^-7; with and without an initial
    state."""
    jcfg, tcfg = cfgs
    ju, tu = _bf16(_u(tcfg, B, T))
    kw_j, kw_t = {}, {}
    if with_init:
        DI, H, P, N = TSSM.ssm_dims(tcfg)
        s0 = (0.3 * np.random.default_rng(7).standard_normal(
            (B, H, P, N))).astype(np.float32)
        kw_j, kw_t = ({"init_state": jnp.asarray(s0)},
                      {"init_state": torch.from_numpy(s0)})
    wout, wstate, wtail = _jfwd(jcfg, params[0], ju, **kw_j)
    gout, gstate, gtail = TSSM.ssd_forward(tcfg, params[1], tu, **kw_t)
    assert gout.dtype == torch.bfloat16 and gtail.dtype == torch.bfloat16
    assert gstate.dtype == torch.float32
    _close(gout, wout, OUT_TOL, "out")
    _close(gstate, wstate, STATE_TOL, "state")
    _close(gtail, wtail, STATE_TOL, "raw tail")


@pytest.mark.parametrize("B", [1, 2])
def test_ssd_step_chain_and_init_state_match_jax(cfgs, params, B):
    """``init_ssm_state`` equals the reference's (zeros, shapes, dtypes);
    then 37 chained bf16 steps from it: each step's out within OUT_TOL of
    JAX's, the state and conv history after every step within
    STATE_TOL."""
    jcfg, tcfg = cfgs
    js, jc = JSSM.init_ssm_state(jcfg, B)
    ts, tc = TSSM.init_ssm_state(tcfg, B, device="cpu")
    for t, j in ((ts, js), (tc, jc)):
        assert tuple(t.shape) == j.shape
        assert str(t.dtype).removeprefix("torch.") == str(j.dtype)
        assert not t.any()
    u = _u(tcfg, B, 37, seed=3)
    for t in range(u.shape[1]):
        ju, tu = _bf16(u[:, t])
        wo, js, jc = _jstep(jcfg, params[0], ju, js, jc)
        go, ts, tc = TSSM.ssd_step(tcfg, params[1], tu, ts, tc)
        _close(go, wo, OUT_TOL, f"step {t} out")
        _close(ts, js, STATE_TOL, f"step {t} state")
        _close(tc, jc, STATE_TOL, f"step {t} conv")


# ---------------------------------------------------------------------------
# tests/test_ssm.py's properties, within the port
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def port_p(cfgs):
    return TSSM.ssd_init(cfgs[1], torch.Generator().manual_seed(0),
                         device="cpu", dtype=torch.float32)


def _randn(cfg, B, T, seed, scale=1.0):
    g = torch.Generator().manual_seed(seed)
    return scale * torch.randn((B, T, cfg.d_model), generator=g)


@pytest.mark.parametrize("B,T", [(1, 16), (2, 33), (3, 64)])
def test_forward_matches_port_reference(cfgs, port_p, B, T):
    """rtol = atol = 5e-2, as tests/test_ssm.py."""
    cfg = cfgs[1]
    u = _randn(cfg, B, T, T, 0.5)
    got, state, _ = TSSM.ssd_forward(cfg, port_p, u.bfloat16())
    want, state_ref = TSSM.ssd_reference(cfg, port_p, u)
    np.testing.assert_allclose(got.float().numpy(), want.numpy(),
                               rtol=5e-2, atol=5e-2)
    np.testing.assert_allclose(state.numpy(), state_ref.numpy(),
                               rtol=5e-2, atol=5e-2)


def test_forward_does_not_depend_on_chunk_size(cfgs, port_p):
    """Chunks of 8, 16 and 48 on one f32 input: rtol = atol = 3e-2, as
    tests/test_ssm.py."""
    cfg = cfgs[1]
    u = _randn(cfg, 2, 48, 5)
    outs = []
    for chunk in (8, 16, 48):
        c = cfg.replace(ssm=dataclasses.replace(cfg.ssm, chunk=chunk))
        outs.append(TSSM.ssd_forward(c, port_p, u)[0].float().numpy())
    for o in outs[1:]:
        np.testing.assert_allclose(outs[0], o, rtol=3e-2, atol=3e-2)


def test_step_chain_matches_forward(cfgs, port_p):
    """20 bf16 steps vs the f32 oracle: rtol = atol = 5e-2, as
    tests/test_ssm.py."""
    cfg = cfgs[1]
    B, T = 2, 20
    u = _randn(cfg, B, T, 9, 0.5)
    want, _ = TSSM.ssd_reference(cfg, port_p, u)
    state, conv = TSSM.init_ssm_state(cfg, B, device="cpu")
    outs = []
    for t in range(T):
        o, state, conv = TSSM.ssd_step(cfg, port_p, u[:, t].bfloat16(),
                                       state, conv)
        outs.append(o.float())
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), want.numpy(),
                               rtol=5e-2, atol=5e-2)


def test_prefill_then_decode_continues(cfgs, port_p):
    """A chunked prefill of 16 tokens, then 8 steps from its state and raw
    tail: rtol = atol = 6e-2 against the oracle, as tests/test_ssm.py."""
    cfg = cfgs[1]
    B, T, cut = 1, 24, 16
    u = _randn(cfg, B, T, 11, 0.5)
    want, _ = TSSM.ssd_reference(cfg, port_p, u)
    _, state, conv = TSSM.ssd_forward(cfg, port_p, u[:, :cut].bfloat16())
    outs = []
    for t in range(cut, T):
        o, state, conv = TSSM.ssd_step(cfg, port_p, u[:, t].bfloat16(),
                                       state, conv)
        outs.append(o.float())
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(),
                               want[:, cut:].numpy(), rtol=6e-2, atol=6e-2)
