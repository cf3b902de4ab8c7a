"""The port's CUDA kernels on the card: each against its plain PyTorch
version, the wrappers' input checks and launch counts, and the engine's
chunk invariance through the kernels.

Every test needs an sm_90 card and skips elsewhere.  This file imports no
JAX, so it runs where JAX is not installed:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: ``tests/conftest.py`` imports JAX.)

bf16 inputs and outputs; the kernel and the plain version both accumulate
in f32, so they differ by the final bf16 rounding (2^-8 relative) plus f32
reordering: ATOL = RTOL = 1e-2.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import registry
from repro_torch.kernels import decode_attention as DA
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops
from repro_torch.kernels import ref as REF
from repro_torch.models import api
from repro_torch.serve.engine import ServeEngine, SliceSpec

ATOL = RTOL = 1e-2

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available() or \
            torch.cuda.get_device_capability() < (9, 0):
        pytest.skip("needs an sm_90 CUDA card")
    return torch.device("cuda")


def _bf16(rng, dev, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                            ).to(dev).to(torch.bfloat16)


def _close(got, want):
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), atol=ATOL,
                               rtol=RTOL)


DECODE_CASES = [                            # (B, H, KH, S, d, lens), options
    ((2, 4, 4, 40, 16, [0, 40]), dict()),
    ((3, 8, 2, 64, 16, [0, 1, 64]), dict(window=8)),
    ((3, 4, 1, 48, 64, [5, 48, 0]), dict(softcap=5.0)),
    ((2, 16, 2, 300, 128, [300, 129]), dict(window=100, softcap=20.0)),
    ((8, 16, 16, 1024, 128, [0, 1, 100, 257, 512, 700, 1000, 1024]), dict()),
]


@pytest.mark.parametrize("shape,kw", DECODE_CASES, ids=str)
def test_decode_kernel_matches_plain(card, shape, kw):
    B, H, KH, S, d, lens = shape
    rng = np.random.default_rng(S)
    q, k, v = (_bf16(rng, card, B, H, d), _bf16(rng, card, B, S, KH, d),
               _bf16(rng, card, B, S, KH, d))
    lens = torch.tensor(lens, dtype=torch.int32, device=card)
    got = DA.paged_decode_attention(q, k, v, lens, **kw)
    _close(got, REF.paged_decode_attention_ref(q, k, v, lens, **kw))
    assert not got[lens == 0].any()


FLASH_CASES = [                             # (B, H, KH, T, S, d), options
    ((2, 4, 4, 32, 32, 16), dict()),
    ((1, 8, 2, 37, 37, 16), dict(window=5, softcap=4.0)),
    ((2, 4, 1, 33, 33, 64), dict(causal=False)),
    ((1, 8, 8, 1, 1, 128), dict()),
    ((2, 16, 4, 77, 77, 128), dict(window=20, scale=0.3)),
    ((8, 16, 16, 128, 128, 128), dict()),
]


@pytest.mark.parametrize("shape,kw", FLASH_CASES, ids=str)
def test_flash_kernel_matches_plain(card, shape, kw):
    B, H, KH, T, S, d = shape
    rng = np.random.default_rng(T)
    q, k, v = (_bf16(rng, card, B, H, T, d), _bf16(rng, card, B, KH, S, d),
               _bf16(rng, card, B, KH, S, d))
    _close(FA.flash_attention(q, k, v, **kw),
           REF.flash_attention_ref(q, k, v, **kw))


def test_wrappers_reject_what_the_kernels_do_not_take(card):
    rng = np.random.default_rng(0)
    q, k = _bf16(rng, card, 2, 4, 16), _bf16(rng, card, 2, 8, 4, 16)
    lens = torch.tensor([3, 8], dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="bfloat16"):
        DA.paged_decode_attention(q.float(), k, k, lens)
    with pytest.raises(ValueError, match="contiguous"):
        DA.paged_decode_attention(q, k.transpose(1, 2), k, lens)
    with pytest.raises(ValueError, match="int32"):
        DA.paged_decode_attention(q, k, k, lens.long())
    with pytest.raises(ValueError, match="head_dim"):
        DA.paged_decode_attention(q[..., :8].contiguous(),
                                  k[..., :8].contiguous(),
                                  k[..., :8].contiguous(), lens)
    fq = _bf16(rng, card, 1, 4, 8, 32)
    with pytest.raises(ValueError, match="head_dim"):
        FA.flash_attention(fq, fq, fq)


def test_ops_routes_cuda_tensors_to_the_kernels(card):
    rng = np.random.default_rng(1)
    q, k = _bf16(rng, card, 2, 4, 16), _bf16(rng, card, 2, 8, 4, 16)
    lens = torch.tensor([3, 8], dtype=torch.int32, device=card)
    before = DA.launches
    ops.paged_decode_attention(q, k, k, lens)
    assert DA.launches == before + 1
    fq = _bf16(rng, card, 1, 4, 8, 16)
    before = FA.launches
    ops.flash_attention(fq, fq, fq)
    assert FA.launches == before + 1


def _serve(params, chunk, device):
    cfg = registry.get_reduced("olmo-1b")
    eng = ServeEngine(cfg, params, SliceSpec(slots=2, max_len=64,
                                             prompt_len=16, chunk=chunk),
                      device=device)
    rng = np.random.default_rng(0)
    reqs = [eng.submit(rng.integers(0, 512, size=n), max_new_tokens=m)
            for n, m in ((5, 12), (16, 6), (9, 10), (12, 7), (3, 9))]
    eng.run()
    return [list(r.out_tokens) for r in reqs]


def test_engine_greedy_chunk_invariant_on_card(card):
    params = api.init_params(registry.get_reduced("olmo-1b"), seed=0,
                             device=card)
    d0, f0 = DA.launches, FA.launches
    ref = _serve(params, 1, card)
    assert DA.launches > d0 and FA.launches > f0
    for chunk in (3, 8):
        assert _serve(params, chunk, card) == ref
