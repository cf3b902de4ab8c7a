"""The port's DLRM scoring path (``repro_torch/models/dlrm.py`` and the DLRM
branches of ``api``) against the JAX package at reduced size: the same
params (handed over through ``repro_torch.interop``) and the same batch
(as numpy) give the same logits through both lookup routes; batches and
params have the reference's layout and distributions.

Tolerance: the dense tower computes in bf16 in both frameworks, with
other matmul kernels, so the logits agree to LOGIT_REL_TOL = 2^-5 of the
largest |logit| (8 bf16 ulps at that scale), as the dense serving tests
use; the embeddings before the tower agree to f32 rounding (2e-5).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
from repro.configs import registry as JREG
from repro.configs.base import DLRMConfig as JDLRM
from repro.configs.base import EmbeddingTableConfig as JTable
from repro.configs.base import ShapeConfig as JShape
from repro.models import api as JAPI
from repro.models import dlrm as JDL
from repro_torch import interop
from repro_torch.configs import registry as TREG
from repro_torch.configs.base import DLRMConfig as TDLRM
from repro_torch.configs.base import EmbeddingTableConfig as TTable
from repro_torch.configs.base import ShapeConfig as TShape
from repro_torch.models import api as TAPI
from repro_torch.models import dlrm as TDL

LOGIT_REL_TOL = 2.0 ** -5
EMB_TOL = 2e-5

# a reduced DLRM with several widths (reduced dlrm0 has one): exercises
# more than one row space through the whole forward
MIXED = [("t0", 40, 8, 1.0, 1, "sum"), ("t1", 90, 16, 4.0, 8, "mean"),
         ("t2", 64, 8, 8.0, 16, "mean"), ("t3", 33, 32, 2.0, 3, "sum"),
         ("t4", 120, 16, 1.0, 1, "mean")]


def _configs(name):
    jcfg, tcfg = JREG.get_reduced("dlrm0"), TREG.get_reduced("dlrm0")
    if name == "mixed":
        tower = dict(bottom_mlp=(32, 16), top_mlp=(64, 32, 1),
                     dense_features=13, interaction="cat")
        jcfg = jcfg.replace(dlrm=JDLRM(tuple(JTable(*r) for r in MIXED),
                                       **tower))
        tcfg = tcfg.replace(dlrm=TDLRM(tuple(TTable(*r) for r in MIXED),
                                       **tower))
    return jcfg, tcfg


@pytest.fixture(scope="module", params=["reduced_dlrm0", "mixed"])
def model(request):
    jcfg, tcfg = _configs(request.param)
    jp = JAPI.init_params(jcfg, jax.random.PRNGKey(0))
    jb = JAPI.make_batch(jcfg, JShape("dlrm_check", "train", 1, 16),
                         jax.random.PRNGKey(1))
    npp = jax.tree.map(np.asarray, jp)
    nb = jax.tree.map(np.asarray, jb)
    return dict(jcfg=jcfg, tcfg=tcfg, jp=jp, jb=jb,
                tp=interop.params_from_numpy(npp),
                tb=interop.params_from_numpy(nb))


def _logits_close(got, want):
    want = np.asarray(want, np.float32)
    tol = LOGIT_REL_TOL * np.abs(want).max()
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=0)


@pytest.mark.parametrize("fused", [True, False])
def test_forward_matches_jax(model, fused):
    """api.forward through the fused or the per-table route (plain
    versions on the CPU) against JAX's forward on the kernel path."""
    want, _ = JDL.forward(model["jcfg"], model["jp"], model["jb"],
                          use_kernel=True, fused=fused)
    got, aux = TAPI.forward(model["tcfg"], model["tp"], model["tb"],
                            fused=fused)
    assert got.dtype == torch.float32 and got.shape == (16,)
    assert aux.item() == 0.0
    _logits_close(got, want)


def test_sparse_forward_matches_jax(model):
    want = JDL.sparse_forward(model["jcfg"], model["jp"], model["jb"])
    for fused in (True, False):
        got = TDL.sparse_forward(model["tcfg"], model["tp"], model["tb"],
                                 fused=fused)
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   atol=EMB_TOL, rtol=2.0 ** -8)


def test_dense_forward_matches_jax(model):
    """The bf16 tower alone, on the reference's own sparse vector."""
    sv = JDL.sparse_forward(model["jcfg"], model["jp"], model["jb"])
    want = JDL.dense_forward(model["jcfg"], model["jp"], model["jb"], sv)
    got = TDL.dense_forward(
        model["tcfg"], model["tp"], model["tb"],
        torch.from_numpy(np.asarray(sv, np.float32)).to(torch.bfloat16))
    _logits_close(got, want)


def test_loss_matches_jax(model):
    want, _ = JDL.loss_fn(model["jcfg"], model["jp"], model["jb"])
    got, _ = TDL.loss_fn(model["tcfg"], model["tp"], model["tb"])
    assert abs(got.item() - float(want)) <= LOGIT_REL_TOL * abs(float(want))


def test_init_params_layout_matches_jax(model):
    tp = TAPI.init_params(model["tcfg"], seed=3, device="cpu")
    jp = jax.tree.map(np.asarray, model["jp"])
    assert {k: tuple(v.shape) for k, v in tp["tables"].items()} == \
        {k: v.shape for k, v in jp["tables"].items()}
    for part in ("bottom", "top"):
        assert [(tuple(l["w"].shape), tuple(l["b"].shape)) for l in tp[part]] \
            == [(l["w"].shape, l["b"].shape) for l in jp[part]]
        for lyr in tp[part]:            # truncated normal / sqrt(fan_in)
            fan_in = lyr["w"].shape[0]
            assert lyr["w"].dtype == torch.float32
            assert lyr["w"].abs().max().item() <= 2.0 / fan_in ** 0.5 + 1e-6
            assert not lyr["b"].any()
    again = TAPI.init_params(model["tcfg"], seed=3, device="cpu")
    assert torch.equal(tp["top"][0]["w"], again["top"][0]["w"])


def test_make_batch_matches_reference_specs(model):
    jcfg, tcfg = model["jcfg"], model["tcfg"]
    shape = TShape("dlrm_check", "train", 1, 512)
    b = TAPI.make_batch(tcfg, shape, seed=0, device="cpu")
    jspecs = JDL.batch_specs(jcfg, JShape("dlrm_check", "train", 1, 512))
    tspecs = TDL.batch_specs(tcfg, shape)
    assert set(b) == set(jspecs) == set(tspecs)
    for k, spec in jspecs.items():
        assert tuple(b[k].shape) == spec.shape == tspecs[k][0], k
        assert str(b[k].dtype).removeprefix("torch.") == str(spec.dtype)
        assert b[k].dtype == tspecs[k][1]
    for t in tcfg.dlrm.tables:
        ids = b[f"cat_{t.name}"]
        assert (ids[:, 0] >= 0).all()               # column 0 always live
        live = ids >= 0
        assert (ids[live] < t.vocab_size).all() and (ids[~live] == -1).all()
        # live share: column 0 plus avg/max of the others
        keep = min(1.0, t.avg_valency / t.max_valency)
        want = (1 + (t.max_valency - 1) * keep) / t.max_valency
        assert abs(live.float().mean().item() - want) < 0.05
        # Zipf-like: the lower half of the vocabulary draws ~sqrt(1/2)
        low = (ids[live] < t.vocab_size // 2).float().mean().item()
        assert abs(low - 0.5 ** 0.5) < 0.05
    again = TAPI.make_batch(tcfg, shape, seed=0, device="cpu")
    assert all(torch.equal(b[k], again[k]) for k in b)
    other = TAPI.make_batch(tcfg, shape, seed=1, device="cpu")
    assert not torch.equal(b["dense"], other["dense"])
    assert "labels" not in TDL.batch_specs(tcfg, dataclasses.replace(
        shape, kind="prefill"))


def test_api_family_guards():
    _, tcfg = _configs("reduced_dlrm0")
    with pytest.raises(ValueError, match="float32"):
        TAPI.init_params(tcfg, device="cpu", dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="no decoder"):
        TAPI.prefill(tcfg, {}, {})
    dense = TREG.get_reduced("olmo-1b")
    # every family of the reference runs; an unknown one is refused
    with pytest.raises(NotImplementedError, match="unknown family"):
        TAPI.forward(dense.replace(family="no-such-family"), {}, {})
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TAPI.make_batch(dense, TShape("x", "train", 8, 2), device="cpu")


def test_collection_is_built_once_per_config():
    _, tcfg = _configs("reduced_dlrm0")
    assert TDL.collection_for(tcfg) is TDL.collection_for(tcfg)
    assert TDL.collection_for(tcfg).fused_storage
