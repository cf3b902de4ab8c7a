"""The port's CUDA kernels on the card: each against its plain PyTorch
version, the wrappers' input checks and launch counts, the engine's
chunk invariance through the kernels, the DLRM forward through the
embedding kernels, DLRM training through both lookup routes (the fused
scatter is the backward of each) against the CPU, the single-table
lookup, the scatter of deduplicated ids and the int8 fused lookup, and
the pooled block-table and int8-KV decode kernels with the pooled decode
path of reduced olmo-1b.

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
kernel is bitwise equal to both, hot runs (split by lanes over blocks)
and both key widths included; against the plain version on the card
by default (atomic adds, in any order) it agrees to SCATTER_TOL = 1e-5 of
each row space's largest |gradient|.  The single-table lookup and the
int8 fused lookup add in column order, as the fused lookup: EMB_ATOL,
EMB_RTOL; the int8 lookup is also within half a scale a row of the f32
one.  The scatter of deduplicated ids sums each run of equal ids in
index order: bitwise the plain version.  The pooled decode kernels read
each row through its table and otherwise run the per-slot body, so they
equal the per-slot kernels on the gathered view bit for bit (bf16 and
int8); the int8 decodes widen each element (f32) as the plain versions
do: ATOL, RTOL.  DLRM logits and gradients (bf16 tower,
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
    # several 64-key tiles: a window that starts inside a tile, GQA, softcap
    ((2, 8, 2, 256, 256, 128), dict(window=100, softcap=30.0)),
    ((1, 16, 4, 512, 512, 64), dict(window=200, softcap=10.0)),
    ((1, 8, 1, 512, 512, 128), dict(window=70)),
    ((2, 4, 2, 200, 333, 16), dict(causal=False, window=50)),
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


def _ordered(fn):
    """``fn()`` under ``torch.use_deterministic_algorithms``."""
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        return fn()
    finally:
        torch.use_deterministic_algorithms(was)


def _hot_case(rng, dev, shapes, counts, B):
    """One slot a row space; row space g's descriptors are the rows of
    ``counts`` ({(g, row): n}) n times each, shuffled over a (B, v_g) span
    padded with -1.  Keys sort by (g, row), so a run starts at the number
    of descriptors with a smaller (g, row)."""
    slots, cols, c0 = [], [], 0
    for g in range(len(shapes)):
        ids = np.concatenate([np.full(n, r) for (h, r), n in counts.items()
                              if h == g])
        v = -(-ids.size // B)
        span = np.full(B * v, -1)
        span[rng.permutation(B * v)[:ids.size]] = rng.permutation(ids)
        cols.append(span.reshape(B, v))
        slots.append((g, c0, c0 + v, 0))
        c0 += v
    rows = torch.from_numpy(np.concatenate(cols, 1).astype(np.int32)).to(dev)
    slots = torch.tensor(slots, dtype=torch.int32, device=dev)
    gout = torch.from_numpy(rng.standard_normal(
        (B, len(shapes), max(d for _, d in shapes))).astype(np.float32)).to(dev)
    return gout, rows, slots, REF.column_slots(slots, c0).int()


def _hot_counts(T):
    """Runs of T - 1, T and T + 1; three hot runs in row space 0 (one on
    its last row, one starting at sorted position 31, the last position of
    the first 32-position chunk) and one in each of row spaces 1 and 2;
    short runs around them."""
    counts = {(0, 0): 31, (0, 1): T + 3, (0, 10): T, (0, 99): T + 1,
              (1, 3): T - 1, (1, 4): T, (1, 7): 40, (2, 0): 2 * T + 7}
    for g, lo, hi in ((0, 2, 99), (1, 8, 40), (2, 1, 30)):
        for r in range(lo, hi):
            counts.setdefault((g, r), 1 + r % 37)
    return counts


def test_fused_scatter_hot_runs_are_bitwise_and_listed(card):
    """Runs at and around the hot threshold, hot runs in one and in
    several row spaces, on a row space's last row and from the last
    position of a chunk, both key widths: bitwise the CPU's sequential sum
    and the deterministic plain version; two launches equal; every run of
    at least HOT_RUN descriptors, and only those, on the hot list, one
    item a 32-lane slice."""
    rng = np.random.default_rng(19)
    T = FS.HOT_RUN
    shapes = [(100, 32), (41, 256), (30, 100)]
    counts = _hot_counts(T)
    gout, rows, slots, cs = _hot_case(rng, card, shapes, counts, 512)
    want = REF.fused_scatter_ref(gout.cpu(), rows.cpu(), slots.cpu(), shapes)
    ordered = _ordered(lambda: REF.fused_scatter_ref(gout, rows, slots,
                                                     shapes, cs))
    got = {}
    for wide in (False, True):
        keys, order = FS._order(rows, slots, cs, shapes, wide=wide)
        assert keys.dtype == (torch.int64 if wide else torch.int32)
        plain = torch.sort(FS.descriptor_keys(rows, slots, cs, shapes, wide),
                           stable=True)
        assert torch.equal(keys, plain[0]) and torch.equal(order, plain[1])
        assert int(keys[31]) == int(keys[31 + T + 2]) != int(keys[30])
        grads = [torch.zeros(s, device=card) for s in shapes]
        hot = FS.reduce_short_runs(grads, gout, cs, keys, order)
        items = FS.hot_items(hot).tolist()
        listed = sorted({(a, b) for a, b, _ in items})
        g, r = FS.split_keys(keys[[a for a, _ in listed]], shapes)
        assert sorted(zip(g.tolist(), r.tolist())) == sorted(
            k for k, n in counts.items() if n >= T)
        for (a, b), gg, rr in zip(listed, g.tolist(), r.tolist()):
            assert b - a == counts[(gg, rr)]     # one item a 32-lane slice
            assert sorted(x for s, e, x in items if (s, e) == (a, b)) == \
                list(range(0, shapes[gg][1], 32))
        FS.reduce_hot_runs(grads, gout, cs, keys, order, hot)
        again = [torch.zeros(s, device=card) for s in shapes]
        FS.reduce_runs(again, gout, cs, keys, order)
        torch.cuda.synchronize()
        for x, y, w, o in zip(grads, again, want, ordered):
            assert torch.equal(x, y) and torch.equal(x.cpu(), w)
            assert torch.equal(x, o)
        got[wide] = grads
    assert all(torch.equal(a, b) for a, b in zip(got[False], got[True]))
    n0 = (FS.launches, FS.launches_hot, FS.launches_keys)
    whole = FS.fused_scatter(gout, rows, slots, cs, shapes)
    assert (FS.launches, FS.launches_hot, FS.launches_keys) == tuple(
        n + 1 for n in n0)
    assert all(torch.equal(a, b) for a, b in zip(whole, got[False]))


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


def _es_bitwise(card, ids, D, V, seed):
    """The scatter of deduplicated ids on ``ids`` (int32 numpy): two
    launches equal, bitwise the CPU's sequential sum and the plain version
    under deterministic algorithms."""
    rng = np.random.default_rng(seed)
    ids = torch.from_numpy(ids.astype(np.int32)).to(card)
    grads = torch.from_numpy(rng.standard_normal((ids.numel(), D)).astype(
        np.float32)).to(card)
    got = ES.embedding_scatter(grads, ids, V)
    again = ES.embedding_scatter(grads, ids, V)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert torch.equal(got.cpu(), REF.embedding_scatter_ref(grads.cpu(),
                                                            ids.cpu(), V))
    assert torch.equal(got, _ordered(
        lambda: REF.embedding_scatter_ref(grads, ids, V)))
    return got


@pytest.mark.parametrize("D", [4, 32, 64, 96, 192, 512])
def test_embedding_scatter_unique_ids_at_every_lane_group_width(card, D):
    """Unique sorted ids (dedup_ids' output: runs of one row, several a
    warp in lane groups of 4 to 32 lanes) with a -1 tail."""
    rng = np.random.default_rng(D)
    V = 3000
    live = np.sort(rng.permutation(V)[:1700])
    got = _es_bitwise(card, np.concatenate([live, np.full(300, -1)]), D, V, D)
    assert got[live].abs().sum(dim=1).gt(0).all()


def test_embedding_scatter_runs_across_chunks(card):
    """A sorted stream of runs of 1-70 equal ids, most of them straddling
    32-position chunks, then one run of 5,000 equal ids."""
    rng = np.random.default_rng(5)
    uniq = np.sort(rng.permutation(900)[:120])
    runs = np.repeat(uniq, rng.integers(1, 71, size=uniq.size))
    _es_bitwise(card, runs, 64, 900, 6)
    _es_bitwise(card, np.concatenate([np.full(5000, 7), [8, -1]]), 32, 10, 7)


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


# -- the lookups' bag combine (csrc/bag_rows.cuh), at tolerance 0 ---------

def _column_order(groups, rows, slots, dmax, scales=None):
    """The lookup as the kernels add it: per slot, an f32 sum over its
    columns in column order (acc += where(valid, row, 0); an int8 row is
    q * its tile's scale first), divided by the count floored at 1 in a
    mean slot; the span clamped to [0, S), ids past the last row read it,
    lanes past the dim zero."""
    B, S = rows.shape
    out = torch.zeros((B, slots.shape[0], dmax), device=rows.device)
    for k, (g, a, b, mean) in enumerate(slots.tolist()):
        table = groups[g]
        rows_g, dim = table.shape
        acc = torch.zeros((B, dim), device=rows.device)
        cnt = torch.zeros((B, 1), device=rows.device)
        for c in range(max(a, 0), min(b, S)):
            ids = rows[:, c].long()
            valid = (ids >= 0)[:, None]
            r = ids.clamp(0, rows_g - 1)
            row = table[r].float()
            if scales is not None:
                row = row * scales[g][r].repeat_interleave(128, 1)[:, :dim]
            acc = acc + torch.where(valid, row, 0.0)
            cnt = cnt + valid
        if mean:
            acc = acc / cnt.clamp_min(1)
        out[:, k, :dim] = acc
    return out


# dims: every lane-group shape of bag_rows.cuh (chunks of 16 bytes: 1-128
# a row); valencies 0, 1, 31-33, 100, 128; B below and above the bags a
# launch spreads (B * K < 128 * 132), not a multiple of a block's bags
BAG_DIMS = [(32, 64, 96, 128, 192, 256),
            (4, 12, 20, 44, 52, 100, 132, 300, 388, 512)]
BAG_SPANS = [0, 1, 31, 32, 33, 100, 128]


def _bag_case(rng, dev, dims, B):
    """Row spaces of ``dims``; one slot of each span width a group, sum
    and mean in turn, plus a clamped span and an empty one; ids in
    [-3, rows + 5) (negatives are no value, ids past the end read the
    last row), a sample with no id, a row repeated over a span."""
    groups = [torch.from_numpy(rng.standard_normal(
        (int(rng.integers(3, 300)), d)).astype(np.float32)).to(dev)
        for d in dims]
    slots, c0 = [], 0
    for i, w in enumerate(BAG_SPANS * ((len(dims) + 1) // 2)):
        slots.append((i % len(dims), c0, c0 + w, i % 2))
        c0 += w
    S = c0
    slots += [(0, -4, 3, 1), (len(dims) - 1, S - 2, S + 9, 0), (1, 5, 5, 1)]
    rows = np.empty((B, S), dtype=np.int32)
    for g, a, b, _ in slots:
        a, b = max(a, 0), min(b, S)
        rows[:, a:b] = rng.integers(-3, groups[g].shape[0] + 5,
                                    size=(B, b - a))
    rows[0] = -1
    if B > 1:
        rows[1, slots[5][1]:slots[5][2]] = 1
    return (groups, torch.from_numpy(rows).to(dev),
            torch.tensor(slots, dtype=torch.int32, device=dev))


@pytest.mark.parametrize("B", [1, 37, 1700])
@pytest.mark.parametrize("dims", BAG_DIMS, ids=str)
def test_fused_lookup_bitwise_column_order(card, dims, B):
    rng = np.random.default_rng(B + len(dims))
    groups, rows, slots = _bag_case(rng, card, dims, B)
    dmax = max(dims)
    got = FL.fused_lookup(groups, rows, slots, dmax)
    torch.cuda.synchronize()
    assert torch.equal(got, _column_order(groups, rows, slots, dmax))
    assert not got[0].any()


def test_fused_lookup_one_slot_one_sample_bitwise(card):
    rng = np.random.default_rng(4)
    table = torch.from_numpy(rng.standard_normal((40, 96)).astype(
        np.float32)).to(card)
    slots = torch.tensor([[0, 0, 100, 1]], dtype=torch.int32, device=card)
    for B in (1, 33):
        rows = torch.from_numpy(rng.integers(-1, 45, size=(B, 100)).astype(
            np.int32)).to(card)
        got = FL.fused_lookup([table], rows, slots, 128)
        torch.cuda.synchronize()
        assert torch.equal(got, _column_order([table], rows, slots, 128))


@pytest.mark.parametrize("B", [1, 37, 1700])
@pytest.mark.parametrize("dims", BAG_DIMS, ids=str)
def test_fused_lookup_q_bitwise_run_to_run_and_bars(card, dims, B):
    rng = np.random.default_rng(B + 7 * len(dims))
    groups, rows, slots = _bag_case(rng, card, dims, B)
    S = rows.shape[1]
    # the plain version takes spans inside [0, S)
    slots[:, 1:3] = slots[:, 1:3].clamp(0, S)
    qts = [QU.quantize_row_space(g) for g in groups]
    qg, qs = [q.q for q in qts], [q.scale for q in qts]
    dmax = max(dims)
    got = FL.fused_lookup_q(qg, qs, rows, slots, dmax)
    assert torch.equal(got, FL.fused_lookup_q(qg, qs, rows, slots, dmax))
    torch.testing.assert_close(got, REF.fused_lookup_q_ref(qg, qs, rows,
                                                           slots, dmax),
                               atol=EMB_ATOL, rtol=EMB_RTOL)
    assert torch.equal(got, _column_order(qg, rows, slots, dmax, qs))
    f32 = FL.fused_lookup(groups, rows, slots, dmax)
    half = REF.fused_lookup_q_ref([torch.ones_like(q) for q in qg],
                                  [x / 2 for x in qs], rows, slots, dmax)
    assert bool(((got - f32).abs()
                 <= half + EMB_ATOL + EMB_RTOL * f32.abs()).all())
    # a row space that is not 16-byte aligned takes 4-byte loads: the same
    # products and sums, so the same bits
    shifted = []
    for q in qg:
        buf = torch.empty(q.numel() + 4, dtype=torch.int8, device=card)
        view = buf[4:].view(q.shape)
        view.copy_(q)
        shifted.append(view)
    assert torch.equal(got, FL.fused_lookup_q(shifted, qs, rows, slots,
                                              dmax))


@pytest.mark.parametrize("combiner", ["sum", "mean"])
@pytest.mark.parametrize("D", [4, 12, 32, 52, 96, 132, 256, 300, 512])
def test_embedding_lookup_bitwise_column_order(card, D, combiner):
    rng = np.random.default_rng(D)
    V = 97
    table = torch.from_numpy(rng.standard_normal((V, D)).astype(np.float32)
                             ).to(card)
    mean = int(combiner == "mean")
    for B, Vl in ((1, 33), (37, 0), (37, 1), (37, 31), (37, 32), (300, 100),
                  (17000, 3), (19, 128)):
        ids = torch.from_numpy(rng.integers(-3, V + 5, size=(B, Vl)).astype(
            np.int32)).to(card)
        slot = torch.tensor([[0, 0, Vl, mean]], dtype=torch.int32,
                            device=card)
        got = EL.embedding_lookup(table, ids, combiner)
        torch.cuda.synchronize()
        assert torch.equal(got, _column_order([table], ids, slot, D)[:, 0])
    view = table[3:50]                   # a row slice of a row space
    ids = torch.from_numpy(rng.integers(-1, 60, size=(45, 40)).astype(
        np.int32)).to(card)
    slot = torch.tensor([[0, 0, 40, mean]], dtype=torch.int32, device=card)
    assert torch.equal(EL.embedding_lookup(view, ids, combiner),
                       _column_order([view], ids, slot, D)[:, 0])


# ---------------------------------------------------------------------------
# Pooled block-table decode and int8-KV decode (rows 3, 1q, 3q)
# ---------------------------------------------------------------------------

POOL_CASES = [                  # (B, H, KH, d, bs, nb, lens), options
    ((3, 8, 2, 16, 8, 6, [0, 1, 48]), dict(window=8)),
    ((3, 4, 1, 64, 16, 5, [80, 33, 0]), dict(softcap=5.0)),
    ((2, 16, 2, 128, 64, 5, [300, 129]), dict(window=100, softcap=20.0)),
    ((2, 4, 4, 128, 8, 40, [320, 7]), dict(scale=0.3)),
    ((8, 16, 16, 128, 16, 64, [0, 1, 100, 257, 512, 700, 1000, 1024]),
     dict()),
]


def _pool_case(rng, dev, B, H, KH, d, bs, nb):
    """q, a pool of 2 * B * nb blocks of random bf16 rows, and tables that
    permute it: slot 1 shares slot 0's first block and the last slot's
    final table entry is the sentinel NB."""
    NB = 2 * B * nb
    q = _bf16(rng, dev, B, H, d)
    k, v = _bf16(rng, dev, NB, bs, KH, d), _bf16(rng, dev, NB, bs, KH, d)
    t = rng.permutation(NB)[:B * nb].reshape(B, nb).astype(np.int32)
    t[1, 0] = t[0, 0]
    t[-1, -1] = NB
    return q, k, v, torch.from_numpy(t).to(dev)


@pytest.mark.parametrize("shape,kw", POOL_CASES, ids=str)
def test_pooled_and_int8_decode_kernels_match_plain(card, shape, kw):
    """Rows 3, 1q and 3q against their plain versions; the pooled launches
    bitwise the per-slot ones on the gathered view."""
    B, H, KH, d, bs, nb, lens = shape
    rng = np.random.default_rng(d + bs)
    q, k, v, tables = _pool_case(rng, card, B, H, KH, d, bs, nb)
    lens = torch.tensor(lens, dtype=torch.int32, device=card)
    got = DA.paged_decode_attention_bt(q, k, v, lens, tables, **kw)
    _close(got, REF.paged_decode_attention_bt_ref(q, k, v, lens, tables,
                                                  **kw))
    assert not got[lens == 0].any()
    flat = DA.paged_decode_attention(q, REF.pool_rows(k, tables),
                                     REF.pool_rows(v, tables), lens, **kw)
    assert torch.equal(got, flat)
    (kq, ks), (vq, vs) = QU.quantize_kv(k), QU.quantize_kv(v)
    got_q = DA.paged_decode_attention_bt_q8(q, kq, ks, vq, vs, lens, tables,
                                            **kw)
    _close(got_q, REF.paged_decode_attention_bt_ref(
        q, kq, vq, lens, tables, k_scale=ks, v_scale=vs, **kw))
    view = [REF.pool_rows(x, tables) for x in (kq, ks, vq, vs)]
    flat_q = DA.paged_decode_attention_q8(q, *view, lens, **kw)
    _close(flat_q, REF.paged_decode_attention_ref(
        q, view[0], view[2], lens, k_scale=view[1], v_scale=view[3], **kw))
    assert torch.equal(got_q, flat_q)


# The decode kernels split a slot's rows into chunks of 128 logical rows
# (CHUNK in csrc/decode_attention.cu): lengths just below, at and above one
# chunk and several chunks, windows that start inside a chunk, a window of
# one row, GQA with G = 8 and 16 at d = 64 and 128 (G = 16: two head groups
# a KV head), G = 64 at d = 16 (eight head groups).
CHUNK_CASES = [                 # (B, H, KH, d, bs, nb, lens), options
    ((4, 16, 16, 128, 16, 24, [127, 128, 129, 384]), dict()),
    ((4, 16, 2, 128, 16, 40, [255, 256, 257, 640]), dict(window=200)),
    ((3, 8, 1, 64, 32, 12, [384, 130, 1]), dict(window=129, softcap=10.0)),
    ((2, 32, 2, 64, 8, 40, [320, 200]), dict(window=64)),
    ((2, 64, 1, 16, 16, 20, [300, 129]), dict()),
    ((2, 4, 4, 128, 16, 32, [512, 300]), dict(window=1)),
]


@pytest.mark.parametrize("shape,kw", CHUNK_CASES, ids=str)
def test_decode_kernels_at_chunk_edges(card, shape, kw):
    """Rows 1, 3, 1q and 3q against their plain versions at the chunk
    edges; rows 3 and 3q bitwise rows 1 and 1q on the gathered view; two
    launches on the same inputs bitwise equal."""
    B, H, KH, d, bs, nb, lens = shape
    rng = np.random.default_rng(d + H + nb)
    q, k, v, tables = _pool_case(rng, card, B, H, KH, d, bs, nb)
    lens = torch.tensor(lens, dtype=torch.int32, device=card)
    view = [REF.pool_rows(x, tables) for x in (k, v)]
    got = DA.paged_decode_attention(q, *view, lens, **kw)
    _close(got, REF.paged_decode_attention_ref(q, *view, lens, **kw))
    assert torch.equal(got, DA.paged_decode_attention(q, *view, lens, **kw))
    got_bt = DA.paged_decode_attention_bt(q, k, v, lens, tables, **kw)
    assert torch.equal(got_bt, got)
    (kq, ks), (vq, vs) = QU.quantize_kv(k), QU.quantize_kv(v)
    view_q = [REF.pool_rows(x, tables) for x in (kq, ks, vq, vs)]
    got_q = DA.paged_decode_attention_q8(q, *view_q, lens, **kw)
    _close(got_q, REF.paged_decode_attention_ref(
        q, view_q[0], view_q[2], lens, k_scale=view_q[1], v_scale=view_q[3],
        **kw))
    assert torch.equal(got_q, DA.paged_decode_attention_q8(q, *view_q, lens,
                                                           **kw))
    assert torch.equal(got_q, DA.paged_decode_attention_bt_q8(
        q, kq, ks, vq, vs, lens, tables, **kw))


# The per-slot bf16 decode kernel's bits: sha256 of `_row1_bits`' outputs,
# from the split-KV kernel (chunks of 128 logical rows, per-lane running
# softmax states, chunks combined in order) built by nvcc 12.9 for sm_90a
# and run on an H100.  A kernel change that moves these bits must update
# the pin on purpose; the pooled and int8 bodies are held to it through
# the bitwise gathered-view tests above.
ROW1_SHA256 = ("c5ce02b66a73e6d489f3e9a5c2a38fd6"
               "b461077ac009c50115162143ca6b9ef0")


def _row1_bits(dev):
    import hashlib
    h = hashlib.sha256()
    for (B, H, KH, S, d, lens), kw in DECODE_CASES:
        rng = np.random.default_rng(S)
        q, k, v = (_bf16(rng, dev, B, H, d), _bf16(rng, dev, B, S, KH, d),
                   _bf16(rng, dev, B, S, KH, d))
        lens = torch.tensor(lens, dtype=torch.int32, device=dev)
        out = DA.paged_decode_attention(q, k, v, lens, **kw)
        h.update(out.view(torch.int16).cpu().numpy().tobytes())
    return h.hexdigest()


def test_decode_kernel_bits_unchanged(card):
    assert _row1_bits(card) == ROW1_SHA256


def test_pooled_and_int8_wrappers_reject_what_the_kernels_do_not_take(card):
    rng = np.random.default_rng(2)
    q, k, v, tables = _pool_case(rng, card, 2, 4, 2, 16, 8, 3)
    lens = torch.tensor([3, 20], dtype=torch.int32, device=card)
    (kq, ks), (vq, vs) = QU.quantize_kv(k), QU.quantize_kv(v)
    with pytest.raises(ValueError, match="int32"):
        DA.paged_decode_attention_bt(q, k, v, lens, tables.long())
    with pytest.raises(ValueError, match="tables must be"):
        DA.paged_decode_attention_bt(q, k, v, lens, tables[:1].contiguous())
    with pytest.raises(ValueError, match="bfloat16"):
        DA.paged_decode_attention_bt(q, k.float(), v.float(), lens, tables)
    with pytest.raises(ValueError, match="int8"):
        DA.paged_decode_attention_bt_q8(q, k, ks, v, vs, lens, tables)
    with pytest.raises(ValueError, match="float32"):
        DA.paged_decode_attention_bt_q8(q, kq, ks.double(), vq, vs, lens,
                                        tables)
    with pytest.raises(ValueError, match="one scale a row"):
        DA.paged_decode_attention_bt_q8(q, kq, ks[:, :4].contiguous(), vq,
                                        vs[:, :4].contiguous(), lens, tables)
    with pytest.raises(ValueError, match="CUDA"):
        DA.paged_decode_attention_bt(q, k, v, lens, tables.cpu())
    sk, ss = REF.pool_rows(kq, tables), REF.pool_rows(ks, tables)
    with pytest.raises(ValueError, match="bfloat16"):
        DA.paged_decode_attention_q8(q.float(), sk, ss, sk, ss, lens)
    with pytest.raises(ValueError, match="one scale a row"):
        DA.paged_decode_attention_q8(q, sk, ss[:, :8].contiguous(), sk,
                                     ss[:, :8].contiguous(), lens)


def test_ops_routes_cuda_int8_and_pooled_tensors_to_the_kernels(card):
    rng = np.random.default_rng(3)
    q, k, v, tables = _pool_case(rng, card, 2, 4, 2, 16, 8, 3)
    lens = torch.tensor([3, 20], dtype=torch.int32, device=card)
    (kq, ks), (vq, vs) = QU.quantize_kv(k), QU.quantize_kv(v)
    view = [REF.pool_rows(x, tables) for x in (kq, ks, vq, vs)]
    n0 = (DA.launches_q, DA.launches_bt, DA.launches_bt_q)
    ops.paged_decode_attention(q, view[0], view[2], lens, k_scale=view[1],
                               v_scale=view[3])
    ops.paged_decode_attention_bt(q, k, v, lens, tables)
    ops.paged_decode_attention_bt(q, kq, vq, lens, tables, k_scale=ks,
                                  v_scale=vs)
    assert (DA.launches_q, DA.launches_bt, DA.launches_bt_q) == tuple(
        n + 1 for n in n0)


def fill_pool(pool, dense, lens, tables):
    """Copy rows [0, lens[b]) of slot b of the per-slot cache ``dense``
    (k, v (L, B, S, KH, hd)) into the pool blocks ``tables[b]`` names, in
    place; a block an earlier slot filled (a shared prefix block) keeps
    that slot's rows.  Returns the set of blocks filled.  (Also used by
    ``tests/test_torch_pooled.py``.)"""
    filled = set()
    bs = pool.k.shape[2]
    for b, n in enumerate(lens):
        for j in range(-(-int(n) // bs)):
            blk = int(tables[b][j])
            if blk in filled:
                continue
            rows = min(bs, int(n) - j * bs)
            for dst, src in ((pool.k, dense.k), (pool.v, dense.v)):
                dst[:, blk, :rows] = src[:, b, j * bs:j * bs + rows]
            filled.add(blk)
    return filled


def test_pooled_decode_invariants_on_card(card):
    """Reduced olmo-1b over a pool (bs 8, 4 slots, slot 1 sharing slot 0's
    first block, slot 3 unadmitted): a greedy loop of pooled steps (row 3)
    gives, bit for bit, the logits of the same loop on the view gathered
    once (row 1) on the admitted slots, and the tokens and pool of
    ``api.decode_n(tables=)``; blocks no slot decodes into are unchanged,
    and ``decode_n(tables=)`` does not depend on the chunk."""
    from repro_torch.models import transformer as TF
    cfg = registry.get_reduced("olmo-1b")
    p = api.init_params(cfg, seed=0, device=card)
    rng = np.random.default_rng(4)
    cached = [11, 17, 6, 0]
    bs, nb, NB = 8, 4, 24
    t = rng.permutation(NB)[:4 * nb].reshape(4, nb).astype(np.int32)
    t[1, 0] = t[0, 0]
    t[3] = NB
    tables = torch.from_numpy(t).to(card)
    toks = rng.integers(0, 512, size=(4, max(cached) + 1)).astype(np.int32)
    toks[1, :bs] = toks[0, :bs]
    _, dense = api.prefill(cfg, p, {"tokens": torch.from_numpy(
        toks[:, :max(cached)]).to(card)})
    start = api.init_kv_pool(cfg, NB, bs, device=card)
    for x in (start.k, start.v):
        x.normal_()
    fill_pool(start, dense, cached, t)
    feed = torch.tensor([toks[b, n] for b, n in enumerate(cached)],
                        dtype=torch.int32, device=card)
    lens0 = torch.tensor(cached, dtype=torch.int32, device=card)
    budget = torch.tensor([5, 5, 5, 0], dtype=torch.int32, device=card)

    def copy(c):
        return TF.Cache(k=c.k.clone(), v=c.v.clone(), pos=c.pos.clone())

    def loop(cache, tables_):
        tk, ln = feed, lens0
        produced = torch.zeros_like(budget)
        outs, logits = [], []
        for _ in range(5):
            active = produced < budget
            lg, cache, ln = TF.decode_step_paged(cfg, p, cache, tk, ln,
                                                 active, tables=tables_)
            tk = torch.where(active, torch.argmax(lg, -1).to(torch.int32), tk)
            produced += active.to(torch.int32)
            outs.append(tk)
            logits.append(lg)
        return torch.stack(outs), torch.stack(logits), cache

    b0, bt0 = DA.launches, DA.launches_bt
    a_toks, a_logits, a_pool = loop(copy(start), tables)
    b_toks, b_logits, _ = loop(TF.pool_view(copy(start), tables), None)
    assert DA.launches_bt - bt0 == 5 * cfg.num_layers
    assert DA.launches - b0 == 5 * cfg.num_layers
    assert torch.equal(a_logits[:, :3], b_logits[:, :3])
    c_toks, c_pool, _, _ = api.decode_n(cfg, p, copy(start), feed, lens0,
                                        budget, num_steps=5, tables=tables)
    assert torch.equal(a_toks, b_toks) and torch.equal(a_toks, c_toks)
    assert torch.equal(a_pool.k, c_pool.k) and torch.equal(a_pool.v,
                                                           c_pool.v)
    decoded = {int(t[b, r // bs]) for b in range(3)
               for r in range(cached[b], cached[b] + 5)}
    keep = [blk for blk in range(NB) if blk not in decoded]
    assert int(t[0, 0]) in keep
    assert torch.equal(c_pool.k[:, keep], start.k[:, keep])
    assert torch.equal(c_pool.v[:, keep], start.v[:, keep])
    one, pool, l1, last = api.decode_n(cfg, p, copy(start), feed, lens0,
                                       budget, num_steps=1, tables=tables)
    three, pool, _, _ = api.decode_n(cfg, p, pool, last, l1,
                                     (budget - 1).clamp_min(0), num_steps=4,
                                     tables=tables)
    assert torch.equal(torch.cat([one, three]), c_toks)
    assert torch.equal(pool.k, c_pool.k) and torch.equal(pool.v, c_pool.v)
