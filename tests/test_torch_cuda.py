"""The port's CUDA kernels on the card: each against its plain PyTorch
version, the wrappers' input checks and launch counts, the engine's
chunk invariance through the kernels, the DLRM forward through the
embedding kernels, DLRM training through both lookup routes (the fused
scatter is the backward of each) against the CPU, and the single-table
lookup, the scatter of deduplicated ids and the int8 fused lookup.

Every test needs an sm_90 card and skips elsewhere.  This file imports no
JAX, so it runs where JAX is not installed:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: ``tests/conftest.py`` imports JAX.)

bf16 inputs and outputs; the kernel and the plain version both accumulate
in f32, so they differ by the final bf16 rounding (2^-8 relative) plus f32
reordering: ATOL = RTOL = 1e-2.  The embedding kernels are f32 in and out:
the fused lookup adds a slot's rows in column order and the plain version
with torch.sum's tree, at most 128 rows of N(0, 1) values, so they agree
to EMB_ATOL = EMB_RTOL = 1e-5; the row gather is a copy and agrees
exactly.  The fused scatter sums each row's descriptors in (b, s) order,
one f32 add at a time, as the plain version's ``index_add_`` does on the
CPU, and as it does on the card under ``torch.use_deterministic_algorithms``
(a stable sort of the indices, then each row's duplicates in order): the
kernel is bitwise equal to both; against the plain version on the card
by default (atomic adds, in any order) it agrees to SCATTER_TOL = 1e-5 of
each row space's largest |gradient|.  The single-table lookup and the
int8 fused lookup add in column order, as the fused lookup: EMB_ATOL,
EMB_RTOL; the int8 lookup is also within half a scale a row of the f32
one.  The scatter of deduplicated ids sums each run of equal ids in
index order: bitwise the plain version.  DLRM logits and gradients (bf16 tower,
cuBLAS vs the CPU's matmuls) agree to 2^-5 of the largest |value|; Adam
on the same gradients to ADAM_RTOL = 1e-6 of each leaf's largest |x|.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import registry
from repro_torch.configs.base import ShapeConfig
from repro_torch.kernels import decode_attention as DA
from repro_torch.kernels import embedding_gather as EG
from repro_torch.kernels import embedding_lookup as EL
from repro_torch.kernels import embedding_scatter as ES
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import fused_lookup as FL
from repro_torch.kernels import fused_scatter as FS
from repro_torch.kernels import ops
from repro_torch.kernels import ref as REF
from repro_torch.models import api
from repro_torch.configs.base import OptimizerConfig, ParallelConfig
from repro_torch.launch import steps as STEPS
from repro_torch.models import dlrm as DL
from repro_torch.models import quant as QU
from repro_torch.optim import adam as OPT
from repro_torch.serve.engine import ServeEngine, SliceSpec

ATOL = RTOL = 1e-2
EMB_ATOL = EMB_RTOL = 1e-5
LOGIT_REL_TOL = 2.0 ** -5
SCATTER_TOL = 1e-5
ADAM_RTOL = 1e-6

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


def _fused_inputs(rng, dev, dims, spec, B):
    """Row spaces of ``dims``; per slot (group, valency, mean); ids uniform
    in [-1, rows) with the edge cases of chip_smoke.py: a mean slot with
    count 0, a sum slot of -1s, one row repeated over a span, a sample
    with no id."""
    groups = [torch.from_numpy(rng.standard_normal(
        (int(rng.integers(5, 500)), d)).astype(np.float32)).to(dev)
        for d in dims]
    slots, cols, c0 = [], [], 0
    for g, w, mean in spec:
        slots.append((g, c0, c0 + w, mean))
        cols.append(rng.integers(-1, groups[g].shape[0], size=(B, w)))
        c0 += w
    rows = np.concatenate(cols, axis=1).astype(np.int32)
    (_, a0, b0, _), (_, a1, b1, _) = slots[0], slots[1]
    rows[0, a0:b0] = rows[0, a1:b1] = -1
    rows[1, a1:b1] = 2
    rows[2, :] = -1
    return (groups, torch.from_numpy(rows).to(dev),
            torch.tensor(slots, dtype=torch.int32, device=dev))


FUSED_CASES = [                  # dims, (group, valency, mean) per slot, B
    ((32, 64, 96, 128, 192, 256),
     [(0, 3, 1), (1, 2, 0), (2, 1, 0), (3, 128, 1), (4, 32, 0), (5, 100, 1),
      (5, 128, 0)], 5),
    ((8,), [(0, 4, 1), (0, 4, 0), (0, 1, 1)], 4),
    ((16, 8, 4), [(1, 1, 1), (0, 5, 1), (2, 2, 0), (0, 17, 0)], 300),
    ((512,), [(0, 40, 0), (0, 33, 1)], 3),
]


@pytest.mark.parametrize("dims,spec,B", FUSED_CASES, ids=str)
def test_fused_lookup_kernel_matches_plain(card, dims, spec, B):
    rng = np.random.default_rng(B)
    groups, rows, slots = _fused_inputs(rng, card, dims, spec, B)
    dmax = max(dims)
    got = FL.fused_lookup(groups, rows, slots, dmax)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, REF.fused_lookup_ref(groups, rows, slots,
                                                         dmax),
                               atol=EMB_ATOL, rtol=EMB_RTOL)
    assert not got[0, :2].any() and not got[2].any()
    for k, (g, *_) in enumerate(spec):
        assert not got[:, k, dims[g]:].any()


@pytest.mark.parametrize("V,D,B,Vl", [(50, 4, 3, 5), (7, 32, 4, 1),
                                      (1000, 256, 64, 128), (3, 96, 2, 10)])
def test_gather_kernel_matches_plain(card, V, D, B, Vl):
    rng = np.random.default_rng(V)
    table = torch.from_numpy(rng.standard_normal((V, D)).astype(np.float32)
                             ).to(card)
    ids = torch.from_numpy(rng.integers(-1, V, size=(B, Vl)).astype(np.int32)
                           ).to(card)
    ids[0] = -1
    got = EG.embedding_gather(table, ids)
    torch.cuda.synchronize()
    assert torch.equal(got, REF.embedding_gather_ref(table, ids))
    assert not got[0].any()
    view = table[1:]                     # a row slice of a row space
    assert torch.equal(EG.embedding_gather(view, ids.clamp_max(V - 2)),
                       REF.embedding_gather_ref(view, ids.clamp_max(V - 2)))


def test_embedding_wrappers_reject_what_the_kernels_do_not_take(card):
    rng = np.random.default_rng(2)
    groups, rows, slots = _fused_inputs(rng, card, (8, 16),
                                        [(0, 3, 0), (1, 2, 1)], 4)
    with pytest.raises(ValueError, match="float32"):
        FL.fused_lookup([g.double() for g in groups], rows, slots, 16)
    with pytest.raises(ValueError, match="int32"):
        FL.fused_lookup(groups, rows.long(), slots, 16)
    with pytest.raises(ValueError, match=r"\(K, 4\)"):
        FL.fused_lookup(groups, rows, slots[:, :3].contiguous(), 16)
    with pytest.raises(ValueError, match="multiple of 4"):
        FL.fused_lookup([groups[0][:, :6].contiguous()], rows, slots, 16)
    with pytest.raises(ValueError, match="multiple of 4"):
        FL.fused_lookup(groups, rows, slots, 8)          # dim 16 > dmax
    with pytest.raises(ValueError, match="row spaces"):
        FL.fused_lookup(groups * 65, rows, slots, 16)
    with pytest.raises(ValueError, match="multiple of 4"):
        EG.embedding_gather(groups[0][:, :6].contiguous(), rows)
    with pytest.raises(ValueError, match="contiguous"):
        EG.embedding_gather(groups[1][:, :8], rows)
    with pytest.raises(ValueError, match="CUDA"):
        EG.embedding_gather(groups[0].cpu(), rows)


def test_ops_routes_cuda_tensors_to_the_embedding_kernels(card):
    rng = np.random.default_rng(3)
    groups, rows, slots = _fused_inputs(rng, card, (8, 16),
                                        [(0, 3, 0), (1, 2, 1)], 4)
    f0, g0 = FL.launches, EG.launches
    ops.fused_lookup(groups, rows, slots, 16)
    ops.embedding_gather(groups[0], rows)
    assert (FL.launches, EG.launches) == (f0 + 1, g0 + 1)


def test_per_table_gradient_on_card_matches_cpu_and_fused(card):
    """The per-table route trains on the card (``ops.GatherRows``: the
    gather kernel forward, one fused-scatter launch per row space
    backward); its gradient equals the CPU's and the fused route's.  The
    raw gather wrapper still refuses a gradient asked of it outside the
    Function, and ``FusedLookup``'s gradient equals the CPU's."""
    rng = np.random.default_rng(4)
    groups, rows, slots = _fused_inputs(rng, card, (8, 16),
                                        [(0, 3, 0), (1, 2, 1)], 4)
    leaf = groups[0].clone().requires_grad_(True)
    g0 = EG.launches
    with pytest.raises(NotImplementedError, match="GatherRows"):
        EG.embedding_gather(leaf, rows)
    assert EG.launches == g0
    f0, s0 = FL.launches, FS.launches
    cs = REF.column_slots(slots, rows.shape[1]).int()
    out = ops.FusedLookup.apply(rows, slots, cs, 16, leaf, groups[1])
    ct = torch.from_numpy(rng.standard_normal(tuple(out.shape)).astype(
        np.float32)).to(card)
    out.backward(ct)
    assert (FL.launches, FS.launches) == (f0 + 1, s0 + 1)
    cpu = [g.cpu().requires_grad_(True) for g in (leaf.detach(), groups[1])]
    ops.FusedLookup.apply(rows.cpu(), slots.cpu(), cs.cpu(), 16,
                          *cpu).backward(ct.cpu())
    torch.testing.assert_close(leaf.grad.cpu(), cpu[0].grad, atol=EMB_ATOL,
                               rtol=EMB_RTOL)
    # through the model: the per-table route's gradients against the CPU's
    # and the fused route's, on the same weights and batch
    cfg = registry.get_reduced("dlrm0")
    p = api.init_params(cfg, seed=0, device="cpu")
    batch = api.make_batch(cfg, ShapeConfig("x", "train", 1, 64), seed=1,
                           device="cpu")
    pg, bg = _to(p, card), _to(batch, card)
    n_tables, n_spaces = len(cfg.dlrm.tables), len(p["tables"])
    g0, s0 = EG.launches, FS.launches
    _, g_card = STEPS.value_and_grad(
        cfg, ParallelConfig(remat="none", emb_pipeline=False), pg, bg)
    torch.cuda.synchronize()
    assert (EG.launches - g0, FS.launches - s0) == (n_tables, n_spaces)
    _, g_cpu = STEPS.value_and_grad(
        cfg, ParallelConfig(remat="none", emb_pipeline=False), p, batch)
    _, g_fused = STEPS.value_and_grad(cfg, ParallelConfig(remat="none"),
                                      _to(p, card), bg)
    for a, b, f in zip(g_card, g_cpu, g_fused):
        assert bool(torch.isfinite(a).all())
        tol = LOGIT_REL_TOL * b.abs().max().item()
        assert (a.cpu() - b).abs().max().item() <= tol
        assert (a - f).abs().max().item() <= tol


def _scatter_inputs(rng, dev, dims, spec, B):
    groups, rows, slots = _fused_inputs(rng, dev, dims, spec, B)
    dmax = max(dims)
    gout = torch.from_numpy(rng.standard_normal(
        (B, len(spec), dmax)).astype(np.float32)).to(dev)
    col_slot = REF.column_slots(slots, rows.shape[1]).int()
    return gout, rows, slots, col_slot, [tuple(g.shape) for g in groups]


SCATTER_CASES = FUSED_CASES + [
    ((8, 4), [(1, 3, 1), (0, 6, 0), (1, 1, 0), (0, 2, 1), (1, 9, 0)], 64),
]


@pytest.mark.parametrize("dims,spec,B", SCATTER_CASES, ids=str)
def test_fused_scatter_kernel_matches_plain(card, dims, spec, B):
    rng = np.random.default_rng(B + 1)
    gout, rows, slots, cs, shapes = _scatter_inputs(rng, card, dims, spec, B)
    s0 = FS.launches
    got = FS.fused_scatter(gout, rows, slots, cs, shapes)
    torch.cuda.synchronize()
    assert FS.launches == s0 + 1
    want_cpu = REF.fused_scatter_ref(gout.cpu(), rows.cpu(), slots.cpu(),
                                     shapes)
    want_card = REF.fused_scatter_ref(gout, rows, slots, shapes)
    torch.use_deterministic_algorithms(True)
    try:
        want_ordered = REF.fused_scatter_ref(gout, rows, slots, shapes, cs)
    finally:
        torch.use_deterministic_algorithms(False)
    for g, wc, wg, wo in zip(got, want_cpu, want_card, want_ordered):
        assert torch.equal(g.cpu(), wc) and torch.equal(g, wo)
        torch.testing.assert_close(g, wg, rtol=0, atol=SCATTER_TOL * max(
            wg.abs().max().item(), 1.0))


def test_fused_scatter_sums_a_hot_row_in_order_and_deterministically(card):
    """One row named 10,000 times in a row (a valency-1 slot), beside a
    slot of random ids and invalid descriptors: the kernel equals the
    sequential sum, and two launches give the same bits."""
    rng = np.random.default_rng(7)
    B = 10_000
    gout, rows, slots, cs, shapes = _scatter_inputs(
        rng, card, (32, 256), [(0, 1, 0), (1, 5, 1), (0, 3, 0)], B)
    rows[:, 0] = 3
    rows[::7, 1:4] = -1
    a = FS.fused_scatter(gout, rows, slots, cs, shapes)
    b = FS.fused_scatter(gout, rows, slots, cs, shapes)
    want = REF.fused_scatter_ref(gout.cpu(), rows.cpu(), slots.cpu(), shapes)
    for x, y, w in zip(a, b, want):
        assert torch.equal(x, y) and torch.equal(x.cpu(), w)
    assert a[0][3].abs().max().item() > 0


def test_fused_scatter_wrapper_rejects_what_the_kernel_does_not_take(card):
    rng = np.random.default_rng(8)
    gout, rows, slots, cs, shapes = _scatter_inputs(
        rng, card, (8, 16), [(0, 3, 0), (1, 2, 1)], 4)
    with pytest.raises(ValueError, match="float32"):
        FS.fused_scatter(gout.double(), rows, slots, cs, shapes)
    with pytest.raises(ValueError, match="int32"):
        FS.fused_scatter(gout, rows.long(), slots, cs, shapes)
    with pytest.raises(ValueError, match=r"\(K, 4\)"):
        FS.fused_scatter(gout, rows, slots[:1], cs, shapes)
    with pytest.raises(ValueError, match=r"\(S,\)"):
        FS.fused_scatter(gout, rows, slots, cs[:-1], shapes)
    with pytest.raises(ValueError, match="int32"):
        FS.fused_scatter(gout, rows, slots, cs.long(), shapes)
    with pytest.raises(ValueError, match="multiple of 4"):
        FS.fused_scatter(gout, rows, slots, cs, [(5, 6), shapes[1]])
    with pytest.raises(ValueError, match="2\\^31"):
        FS.fused_scatter(gout, rows, slots, cs, [(2 ** 31, 8), shapes[1]])
    with pytest.raises(ValueError, match="CUDA"):
        FS.fused_scatter(gout.cpu(), rows, slots, cs, shapes)


def _to(tree, dev):
    return OPT.tree_map(lambda t: t.detach().to(dev), tree)


def test_dlrm_train_step_on_card_matches_cpu(card):
    """Reduced dlrm0, same weights and batch: the card's gradients (fused
    lookup + fused scatter) against the CPU's, then Adam on the same
    gradients, then a few Trainer steps with finite losses."""
    cfg = registry.get_reduced("dlrm0")
    p = api.init_params(cfg, seed=0, device="cpu")
    batch = api.make_batch(cfg, ShapeConfig("x", "train", 1, 64), seed=1,
                           device="cpu")
    pg, bg = _to(p, card), _to(batch, card)
    pcfg = ParallelConfig(remat="none")
    s0 = FS.launches
    _, g_cpu = STEPS.value_and_grad(cfg, pcfg, p, batch)
    _, g_card = STEPS.value_and_grad(cfg, pcfg, pg, bg)
    torch.cuda.synchronize()
    assert FS.launches == s0 + 1
    for a, b in zip(g_card, g_cpu):
        tol = LOGIT_REL_TOL * b.abs().max().item()
        assert (a.cpu() - b).abs().max().item() <= tol
    ocfg = OptimizerConfig(lr=1e-2, warmup_steps=1)
    g_same = [g.cpu() for g in g_card]
    with torch.no_grad():
        pc = _to(pg, "cpu")
    p1, s1, _ = OPT.apply(ocfg, pg, g_card, OPT.init(ocfg, pg))
    p2, s2, _ = OPT.apply(ocfg, pc, g_same, OPT.init(ocfg, pc))
    for x, y in zip(OPT.leaves([p1, s1.mu, s1.nu]),
                    OPT.leaves([p2, s2.mu, s2.nu])):
        torch.testing.assert_close(x.detach().cpu(), y.detach(),
                                   rtol=ADAM_RTOL,
                                   atol=ADAM_RTOL * y.abs().max().item())


def test_dlrm_forward_on_card_matches_cpu(card):
    """Reduced dlrm0, same weights and batch: the kernel routes on the card
    against the plain versions on the CPU; 1 fused launch a forward, one
    gather a table on the per-table route."""
    cfg = registry.get_reduced("dlrm0")
    p = api.init_params(cfg, seed=0, device="cpu")
    batch = api.make_batch(cfg, ShapeConfig("x", "train", 1, 32), seed=1,
                           device="cpu")
    to = lambda t: t.to(card)
    pg = {"tables": {k: to(v) for k, v in p["tables"].items()},
          "bottom": [{k: to(v) for k, v in l.items()} for l in p["bottom"]],
          "top": [{k: to(v) for k, v in l.items()} for l in p["top"]]}
    bg = {k: to(v) for k, v in batch.items()}
    for fused in (True, False):
        want = api.forward(cfg, p, batch, fused=fused)[0]
        f0, g0 = FL.launches, EG.launches
        with torch.inference_mode():
            got = api.forward(cfg, pg, bg, fused=fused)[0]
        torch.cuda.synchronize()
        assert (FL.launches - f0, EG.launches - g0) == \
            ((1, 0) if fused else (0, len(cfg.dlrm.tables)))
        tol = LOGIT_REL_TOL * want.abs().max().item()
        assert (got.cpu() - want).abs().max().item() <= tol
        lk, _ = DL.loss_fn(cfg, pg, bg, fused=fused)
        assert torch.isfinite(lk)


# -- the single-table lookup, the scatter of deduplicated ids, int8 lookup --

@pytest.mark.parametrize("combiner", ["sum", "mean"])
@pytest.mark.parametrize("V,D,B,Vl", [(8192, 64, 64, 16), (7, 32, 4, 1),
                                      (1000, 256, 33, 128), (3, 96, 2, 40),
                                      (50, 512, 9, 5), (20, 4, 300, 3)])
def test_embedding_lookup_kernel_matches_plain(card, combiner, V, D, B, Vl):
    rng = np.random.default_rng(V + Vl)
    table = torch.from_numpy(rng.standard_normal((V, D)).astype(np.float32)
                             ).to(card)
    ids = torch.from_numpy(rng.integers(-1, V, size=(B, Vl)).astype(np.int32)
                           ).to(card)
    ids[0] = -1                          # no valid id: zeros, sum or mean
    ids[1, :] = V - 1                    # one row repeated over the span
    e0 = EL.launches
    got = EL.embedding_lookup(table, ids, combiner)
    torch.cuda.synchronize()
    assert EL.launches == e0 + 1
    torch.testing.assert_close(got, REF.embedding_lookup_ref(table, ids,
                                                             combiner),
                               atol=EMB_ATOL, rtol=EMB_RTOL)
    assert not got[0].any()
    assert torch.equal(got, EL.embedding_lookup(table, ids, combiner))
    view = table[1:]                     # a row slice of a row space
    vid = ids.clamp_max(V - 2)
    torch.testing.assert_close(EL.embedding_lookup(view, vid, combiner),
                               REF.embedding_lookup_ref(view, vid, combiner),
                               atol=EMB_ATOL, rtol=EMB_RTOL)


def _sorted_ids(rng, V, N, dup):
    """Unique sorted ids with a -1 tail, or (``dup``) a sorted stream with
    runs of equal ids, a -1 tail and ids past V."""
    if dup:
        ids = np.sort(rng.integers(0, V, size=N - 8))
        ids = np.concatenate([ids, [V, V + 5], np.full(6, -1)])
    else:
        live = np.sort(rng.permutation(V)[:N // 2])
        ids = np.concatenate([live, np.full(N - live.size, -1)])
    return ids.astype(np.int32)


@pytest.mark.parametrize("dup", [False, True])
@pytest.mark.parametrize("V,D,N", [(32, 8, 10), (128, 64, 40),
                                   (5000, 256, 3000), (40, 512, 100),
                                   (3, 4, 1000)])
def test_embedding_scatter_kernel_is_bitwise_plain(card, dup, V, D, N):
    """Unique ids: bitwise the plain version (0 + each row).  Adjacent
    duplicates: bitwise the plain version under deterministic algorithms
    (index order) and on the CPU; two launches give the same bits."""
    if not dup and N // 2 > V:
        N = 2 * V
    rng = np.random.default_rng(V + N)
    ids = torch.from_numpy(_sorted_ids(rng, V, N, dup)).to(card)
    grads = torch.from_numpy(rng.standard_normal((ids.numel(), D)).astype(
        np.float32)).to(card)
    e0 = ES.launches
    got = ES.embedding_scatter(grads, ids, V)
    again = ES.embedding_scatter(grads, ids, V)
    torch.cuda.synchronize()
    assert ES.launches == e0 + 2 and torch.equal(got, again)
    assert torch.equal(got.cpu(), REF.embedding_scatter_ref(grads.cpu(),
                                                            ids.cpu(), V))
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        want = REF.embedding_scatter_ref(grads, ids, V)
    finally:
        torch.use_deterministic_algorithms(was)
    assert torch.equal(got, want)


def _q_inputs(rng, dev, dims, spec, B):
    groups, rows, slots = _fused_inputs(rng, dev, dims, spec, B)
    qts = [QU.quantize_row_space(g) for g in groups]
    return [q.q for q in qts], [q.scale for q in qts], rows, slots, groups


@pytest.mark.parametrize("dims,spec,B", FUSED_CASES, ids=str)
def test_fused_lookup_q_kernel_matches_plain(card, dims, spec, B):
    rng = np.random.default_rng(B + 1)
    qg, qs, rows, slots, groups = _q_inputs(rng, card, dims, spec, B)
    dmax = max(dims)
    q0 = FL.launches_q
    got = FL.fused_lookup_q(qg, qs, rows, slots, dmax)
    torch.cuda.synchronize()
    assert FL.launches_q == q0 + 1
    torch.testing.assert_close(got, REF.fused_lookup_q_ref(qg, qs, rows,
                                                           slots, dmax),
                               atol=EMB_ATOL, rtol=EMB_RTOL)
    assert not got[0, :2].any() and not got[2].any()
    for k, (g, *_) in enumerate(spec):
        assert not got[:, k, dims[g]:].any()
    # against kernel 4 on the f32 tables: round-to-nearest int8 moves each
    # row by at most half its tile's scale (the bound: the same lookup of
    # ones with half the scales), plus f32 rounding
    f32 = FL.fused_lookup(groups, rows, slots, dmax)
    half = REF.fused_lookup_q_ref([torch.ones_like(q) for q in qg],
                                  [x / 2 for x in qs], rows, slots, dmax)
    assert bool(((got - f32).abs()
                 <= half + EMB_ATOL + EMB_RTOL * f32.abs()).all())


def test_sparsecore_wrappers_reject_what_the_kernels_do_not_take(card):
    rng = np.random.default_rng(9)
    qg, qs, rows, slots, groups = _q_inputs(rng, card, (8, 16),
                                            [(0, 3, 0), (1, 2, 1)], 4)
    table, ids = groups[1], rows[:, :3].contiguous()
    with pytest.raises(ValueError, match="float32"):
        EL.embedding_lookup(table.double(), ids)
    with pytest.raises(ValueError, match="int32"):
        EL.embedding_lookup(table, ids.long())
    with pytest.raises(ValueError, match="2 dims"):
        EL.embedding_lookup(table, ids[0])
    with pytest.raises(ValueError, match="combiner"):
        EL.embedding_lookup(table, ids, "max")
    with pytest.raises(ValueError, match="CUDA"):
        EL.embedding_lookup(table.cpu(), ids)
    with pytest.raises(NotImplementedError, match="no backward"):
        EL.embedding_lookup(table.clone().requires_grad_(True), ids)
    uniq = torch.tensor([0, 2, 3, -1], dtype=torch.int32, device=card)
    grads = torch.ones((4, 16), device=card)
    with pytest.raises(ValueError, match="float32"):
        ES.embedding_scatter(grads.double(), uniq, 8)
    with pytest.raises(ValueError, match="int32"):
        ES.embedding_scatter(grads, uniq.long(), 8)
    with pytest.raises(ValueError, match="disagree on N"):
        ES.embedding_scatter(grads[:3].contiguous(), uniq, 8)
    with pytest.raises(ValueError, match="multiple of 4"):
        ES.embedding_scatter(grads[:, :6].contiguous(), uniq, 8)
    with pytest.raises(ValueError, match="CUDA"):
        ES.embedding_scatter(grads.cpu(), uniq.cpu(), 8)
    with pytest.raises(ValueError, match="int8"):
        FL.fused_lookup_q(groups, qs, rows, slots, 16)
    with pytest.raises(ValueError, match="one per 128-lane tile"):
        FL.fused_lookup_q(qg, [s[:, :0].contiguous() for s in qs], rows,
                          slots, 16)
    with pytest.raises(ValueError, match="scale tables"):
        FL.fused_lookup_q(qg, qs[:1], rows, slots, 16)
    with pytest.raises(ValueError, match="CUDA"):
        FL.fused_lookup_q([q.cpu() for q in qg], qs, rows, slots, 16)


def test_ops_routes_cuda_tensors_to_the_sparsecore_kernels(card):
    rng = np.random.default_rng(10)
    qg, qs, rows, slots, groups = _q_inputs(rng, card, (8, 16),
                                            [(0, 3, 0), (1, 2, 1)], 4)
    uniq = torch.tensor([0, 2, 3, -1], dtype=torch.int32, device=card)
    e0, s0, q0 = EL.launches, ES.launches, FL.launches_q
    ops.embedding_lookup(groups[0], rows, "mean")
    ops.embedding_scatter(torch.ones((4, 8), device=card), uniq, 5)
    ops.fused_lookup_q(qg, qs, rows, slots, 16)
    assert (EL.launches, ES.launches, FL.launches_q) == (e0 + 1, s0 + 1,
                                                         q0 + 1)
