"""Dense layer pieces of the port (``repro_torch/models/layers.py``) against
``repro/models/layers.py`` on the same bf16 inputs and f32 weights.

Both sides round to bf16 at the same points, but the two frameworks may
round an intermediate at different places (XLA may keep an elementwise
chain in f32).  Outputs are O(1), so they are held to two bf16 ulps at
unit scale: ATOL = RTOL = 2 * 2**-7."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.configs import registry as JREG
from repro.models import layers as JL
from repro_torch.configs import registry as TREG
from repro_torch.models import layers as TL

ATOL = RTOL = 2 * 2.0 ** -7


def _bf16_pair(a):
    """The same bf16 values in both frameworks (numpy has no bf16)."""
    t = torch.from_numpy(a).to(torch.bfloat16)
    return t, jnp.asarray(a).astype(jnp.bfloat16)


def _close(t, j, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(t.float().numpy(),
                               np.asarray(j.astype(jnp.float32)),
                               atol=atol, rtol=rtol)


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(0)


@pytest.mark.parametrize("norm", ["nonparam_ln", "rmsnorm", "layernorm"])
def test_norms(rng, norm):
    x_t, x_j = _bf16_pair((rng.standard_normal((2, 5, 64)) * 3 + 1)
                          .astype(np.float32))
    w = rng.standard_normal(64).astype(np.float32)
    b = rng.standard_normal(64).astype(np.float32)
    if norm == "nonparam_ln":
        got, want = TL.nonparam_ln(x_t), JL.nonparam_ln(x_j)
    elif norm == "rmsnorm":
        got = TL.rmsnorm(x_t, torch.from_numpy(w))
        want = JL.rmsnorm(x_j, jnp.asarray(w))
    else:
        got = TL.layernorm(x_t, torch.from_numpy(w), torch.from_numpy(b))
        want = JL.layernorm(x_j, jnp.asarray(w), jnp.asarray(b))
    assert got.dtype == torch.bfloat16
    _close(got, want)


def test_apply_norm_dispatches_like_reference(rng):
    cfg_t, cfg_j = TREG.get_reduced("olmo-1b"), JREG.get_reduced("olmo-1b")
    x_t, x_j = _bf16_pair(rng.standard_normal((3, 64)).astype(np.float32))
    _close(TL.apply_norm(cfg_t, {}, x_t), JL.apply_norm(cfg_j, {}, x_j))


@pytest.mark.parametrize("theta", [10000.0, 500000.0])
def test_rope_neox_half_rotation(rng, theta):
    x_t, x_j = _bf16_pair(rng.standard_normal((2, 6, 4, 16))
                          .astype(np.float32))
    pos = rng.integers(0, 1000, size=(2, 6)).astype(np.int32)
    got = TL.apply_rope(x_t, torch.from_numpy(pos), theta)
    want = JL.apply_rope(x_j, jnp.asarray(pos), theta)
    _close(got, want)
    # per-slot decode positions: (B, 1)
    got = TL.apply_rope(x_t[:, :1], torch.from_numpy(pos[:, :1]), theta)
    _close(got, JL.apply_rope(x_j[:, :1], jnp.asarray(pos[:, :1]), theta))


def _attn_params(rng, d=64, H=4, KH=2, hd=16, bias=False):
    p = {"wq": rng.standard_normal((d, H, hd)) / np.sqrt(d),
         "wk": rng.standard_normal((d, KH, hd)) / np.sqrt(d),
         "wv": rng.standard_normal((d, KH, hd)) / np.sqrt(d),
         "wo": rng.standard_normal((H * hd, d)) / np.sqrt(H * hd)}
    if bias:
        p.update(bq=rng.standard_normal((H, hd)) * 0.1,
                 bk=rng.standard_normal((KH, hd)) * 0.1,
                 bv=rng.standard_normal((KH, hd)) * 0.1)
    p = {k: v.astype(np.float32) for k, v in p.items()}
    return ({k: torch.from_numpy(v) for k, v in p.items()},
            {k: jnp.asarray(v) for k, v in p.items()})


@pytest.mark.parametrize("bias", [False, True])
def test_attention_qkv_and_out(rng, bias):
    cfg = TREG.get_reduced("olmo-1b")
    a = cfg.attention
    pt, pj = _attn_params(rng, bias=bias)
    x_t, x_j = _bf16_pair(rng.standard_normal((2, 5, 64)).astype(np.float32))
    pos = np.broadcast_to(np.arange(5, dtype=np.int32), (2, 5)).copy()
    qt, kt, vt = TL.attention_qkv(pt, x_t, a, torch.from_numpy(pos))
    qj, kj, vj = JL.attention_qkv(pj, x_j, a, jnp.asarray(pos))
    for t, j in ((qt, qj), (kt, kj), (vt, vj)):
        assert t.dtype == torch.bfloat16 and tuple(t.shape) == j.shape
        _close(t, j)
    o_t, o_j = _bf16_pair(rng.standard_normal((2, 5, 4, 16))
                          .astype(np.float32))
    _close(TL.attention_out(pt, o_t), JL.attention_out(pj, o_j))


def test_mlp_silu_glu(rng):
    cfg_t, cfg_j = TREG.get_reduced("olmo-1b"), JREG.get_reduced("olmo-1b")
    p = {"wg": rng.standard_normal((64, 128)) / 8.0,
         "wu": rng.standard_normal((64, 128)) / 8.0,
         "wo": rng.standard_normal((128, 64)) / np.sqrt(128)}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x_t, x_j = _bf16_pair(rng.standard_normal((2, 5, 64)).astype(np.float32))
    got = TL.mlp_apply(cfg_t, {k: torch.from_numpy(v) for k, v in p.items()},
                       x_t)
    want = JL.mlp_apply(cfg_j, {k: jnp.asarray(v) for k, v in p.items()}, x_j)
    assert got.dtype == torch.bfloat16
    _close(got, want)


@pytest.mark.parametrize("cap", [None, 30.0])
def test_softcap(rng, cap):
    x = (rng.standard_normal((4, 7)) * 50).astype(np.float32)
    got = TL.softcap(torch.from_numpy(x), cap)
    want = JL.softcap(jnp.asarray(x), cap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-5)
