"""Plain versions of the port's kernels (``repro_torch/kernels/ref.py``)
against the JAX package's Pallas kernels in interpret mode and its jnp
oracles, and the device dispatch in ``ops``.  The CUDA kernels are held
against these plain versions on the card by ``tests/test_torch_cuda.py``
and ``chip_smoke.py``.

Inputs are f32 from one numpy seed; the plain versions and the oracles
compute the same f32 math in another summation order, so they agree to
ATOL = RTOL = 2e-5 (about 100 f32 ulps at unit scale)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels import ref as JREF
from repro.kernels.decode_attention import paged_decode_attention_kernel_call
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro_torch.kernels import decode_attention as TDA
from repro_torch.kernels import flash_attention as TFA
from repro_torch.kernels import ops as TOPS
from repro_torch.kernels import ref as TREF

ATOL = RTOL = 2e-5


def _arr(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _close(got, want, atol=ATOL, rtol=RTOL):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32),
                               atol=atol, rtol=rtol)


MHA, GQA, MQA = (2, 4, 4, 40, 16), (3, 8, 2, 64, 16), (3, 4, 1, 48, 32)
GEMMA = (3, 4, 2, 40, 256)
DECODE_CASES = [                # (B, H, KH, S, d), options
    (MHA, dict()),              # S not a multiple of the Pallas block
    (GQA, dict(window=8)),
    (MQA, dict(softcap=5.0)),
    (GQA, dict(window=16, softcap=3.0, scale=0.3)),
    # gemma2-9b's head_dim 256 and GQA 2: its softcap, scale and a window
    (GEMMA, dict(window=24, softcap=50.0, scale=256 ** -0.5)),
    (GEMMA, dict(softcap=1.0)),
]


def _decode_inputs(B, H, KH, S, d, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = _arr(rng, B, H, d), _arr(rng, B, S, KH, d), _arr(rng, B, S, KH, d)
    lens = rng.integers(1, S + 1, size=B).astype(np.int32)
    lens[0] = 0                             # empty slot -> zeros
    lens[-1] = S                            # full slot
    if B > 2:
        lens[1] = 1
    return q, k, v, lens


@pytest.mark.parametrize("shape,kw", DECODE_CASES, ids=str)
def test_decode_ref_matches_pallas_and_oracle(shape, kw):
    q, k, v, lens = _decode_inputs(*shape)
    got = TREF.paged_decode_attention_ref(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(lens), **kw)
    pallas = paged_decode_attention_kernel_call(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens),
        interpret=True, **kw)
    oracle = JREF.paged_decode_attention_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens),
        **kw)
    _close(got, pallas)
    _close(got, oracle)
    assert not got[0].any()                 # seq_len 0 writes zeros


# tile-aligned T and S: the Pallas kernel asserts T % bq == 0, S % bk == 0
FMHA, FGQA = (2, 4, 4, 32, 32, 16), (1, 8, 2, 32, 32, 16)
FLASH_CASES = [                 # (B, H, KH, T, S, d), options
    (FMHA, dict()),
    (FGQA, dict(window=8)),
    (FMHA, dict(softcap=5.0)),
    (FGQA, dict(causal=False)),
    (FMHA, dict(window=12, softcap=3.0, scale=0.3)),
    # gemma2-9b's head_dim 256 and GQA 2
    ((1, 4, 2, 32, 32, 256), dict(window=12, softcap=50.0,
                                  scale=256 ** -0.5)),
    ((2, 2, 1, 32, 32, 256), dict(softcap=1.0)),
]


def _flash_inputs(B, H, KH, T, S, d, seed=1):
    rng = np.random.default_rng(seed)
    return (_arr(rng, B, H, T, d), _arr(rng, B, KH, S, d),
            _arr(rng, B, KH, S, d))


@pytest.mark.parametrize("shape,kw", FLASH_CASES, ids=str)
def test_flash_ref_matches_pallas_and_oracle(shape, kw):
    q, k, v = _flash_inputs(*shape)
    got = TREF.flash_attention_ref(*map(torch.from_numpy, (q, k, v)), **kw)
    pallas = pallas_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          bq=16, bk=16, interpret=True, **kw)
    oracle = JREF.flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), **kw)
    _close(got, pallas)
    _close(got, oracle)


@pytest.mark.parametrize("T,kw", [(1, dict()), (17, dict(window=5, softcap=4.0)),
                                  (37, dict())], ids=str)
def test_flash_ref_ragged_T_matches_oracle(T, kw):
    """Ragged T (the engine's prompt length): the Pallas kernel asserts
    divisibility, so the oracle is the jnp reference alone."""
    q, k, v = _flash_inputs(2, 4, 2, T, T, 16, seed=T)
    got = TREF.flash_attention_ref(*map(torch.from_numpy, (q, k, v)), **kw)
    _close(got, JREF.flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v), **kw))


def test_ops_sends_cpu_tensors_to_plain_versions():
    q, k, v, lens = map(torch.from_numpy, _decode_inputs(2, 4, 2, 24, 16))
    assert torch.equal(
        TOPS.paged_decode_attention(q, k, v, lens, window=7),
        TREF.paged_decode_attention_ref(q, k, v, lens, window=7))
    fq, fk, fv = map(torch.from_numpy, _flash_inputs(1, 4, 2, 9, 9, 16))
    assert torch.equal(TOPS.flash_attention(fq, fk, fv, softcap=2.0),
                       TREF.flash_attention_ref(fq, fk, fv, softcap=2.0))


def test_kernel_wrappers_refuse_cpu_tensors():
    """A wrapper launches or raises: it never computes on the CPU."""
    q, k, v, lens = map(torch.from_numpy, _decode_inputs(2, 4, 2, 24, 16))
    bf = lambda t: t.to(torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        TDA.paged_decode_attention(bf(q), bf(k), bf(v), lens)
    fq, fk, fv = map(torch.from_numpy, _flash_inputs(1, 4, 2, 9, 9, 16))
    with pytest.raises(ValueError, match="CUDA"):
        TFA.flash_attention(bf(fq), bf(fk), bf(fv))
    assert TDA.launches == 0 and TFA.launches == 0
