"""The port's embedding engine (``repro_torch/embeddings``) and the plain
versions of its two lookup kernels (``repro_torch/kernels/ref.py``)
against the JAX package: placement plan and storage layout, the fused
lookup against the Pallas kernel in interpret mode and its jnp oracle,
the row gather against its Pallas kernel, both lookup routes against
``EmbeddingCollection.lookup(use_kernel=True)``, gradients through the
plain versions against ``jax.grad``, the fused scatter (the fused
lookup's backward) against its Pallas kernel and oracle, and
``ops.FusedLookup``'s gradient against ``jax.vjp`` of the reference's
``ops.fused_lookup`` ``custom_vjp``.

Inputs come from one numpy seed per case and tables are handed over as
numpy.  Tolerance: f32 in, f32 out; the port and the reference add a
slot's rows in other orders, so they agree to ATOL = RTOL = 2e-5 (about
100 f32 ulps at unit scale), as in ``tests/test_torch_kernels_ref.py``.
The row gather is a copy and must agree exactly.  The fused scatter adds
in (b, s) order in both frameworks: SCATTER_RTOL = 1e-6 of each leaf's
largest |gradient|; through ``FusedLookup`` (mean scaling, then the
scatter) VJP_TOL = 1e-5.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs import registry as JREG
from repro.configs.base import EmbeddingTableConfig as JTable
from repro.embeddings import engine as JENG
from repro.embeddings import sharding as JSH
from repro.kernels import ref as JREF
from repro.kernels import ops as JOPS
from repro.kernels.embedding_grad import fused_scatter_kernel_call
from repro.kernels.embedding_lookup import (fused_lookup_kernel_call,
                                            gather_kernel_call)
from repro_torch.configs.base import EmbeddingTableConfig as TTable
from repro_torch.embeddings import cache as TCACHE
from repro_torch.embeddings import engine as TENG
from repro_torch.embeddings import sharding as TSH
from repro_torch.kernels import embedding_gather as TEG
from repro_torch.kernels import embedding_lookup as TEL
from repro_torch.kernels import embedding_scatter as TES
from repro_torch.kernels import fused_lookup as TFL
from repro_torch.kernels import fused_scatter as TFS
from repro_torch.kernels import ops as TOPS
from repro_torch.kernels import ref as TREF
from repro_torch.models import quant as TQ

ATOL = RTOL = 2e-5
SCATTER_RTOL = 1e-6
VJP_TOL = 1e-5


def _close(got, want, atol=ATOL, rtol=RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32),
                               atol=atol, rtol=rtol)


def _specs(rows):
    """(name, vocab, dim, avg valency, max valency, combiner) -> both
    frameworks' table configs."""
    return ([JTable(*r) for r in rows], [TTable(*r) for r in rows])


# table lists the layout tests cover, without hypothesis: one width, mixed
# widths in any order, a table whose vocab is a multiple of nothing, big
# tables (row/table sharded with 4 shards) next to small ones
TABLE_LISTS = {
    "one_dim": [("a", 120, 8, 4.0, 4, "sum"), ("b", 500, 8, 2.0, 2, "mean")],
    "mixed": [("a", 120, 8, 4.0, 4, "sum"), ("b", 500, 8, 2.0, 2, "mean"),
              ("c", 60, 16, 1.0, 1, "sum"), ("d", 90, 16, 4.0, 4, "mean"),
              ("e", 33, 32, 3.0, 5, "mean")],
    "unsorted": [("z", 7, 64, 1.0, 1, "mean"), ("y", 1000, 4, 8.0, 16, "sum"),
                 ("x", 999, 64, 2.0, 3, "sum"), ("w", 1, 4, 1.0, 2, "mean")],
    "big": [("huge", 3_000_000, 64, 1.0, 1, "sum"),
            ("mid", 300_000, 32, 2.0, 4, "mean"),
            ("small", 100, 16, 1.0, 2, "sum"),
            ("huge2", 1_500_001, 128, 3.0, 8, "mean")],
}


def _reduced_dlrm_rows():
    cfg = JREG.get_reduced("dlrm0")
    return [tuple(getattr(t, f.name) for f in dataclasses.fields(t))
            for t in cfg.dlrm.tables]


LAYOUT_CASES = [(name, rows) for name, rows in TABLE_LISTS.items()] + [
    ("reduced_dlrm0", _reduced_dlrm_rows())]


@pytest.mark.parametrize("num_shards", [1, 4])
@pytest.mark.parametrize("name,rows", LAYOUT_CASES,
                         ids=[c[0] for c in LAYOUT_CASES])
def test_plan_placement_matches_reference(name, rows, num_shards):
    jspecs, tspecs = _specs(rows)
    jplan = JSH.plan_placement(jspecs, num_shards)
    tplan = TSH.plan_placement(tspecs, num_shards)
    assert list(tplan) == list(jplan)
    for k in jplan:
        assert dataclasses.asdict(tplan[k]) == dataclasses.asdict(jplan[k])
    assert TSH.plan_summary(tplan) == JSH.plan_summary(jplan)


def _groups(groups):
    return {d: (g.name, g.total_rows,
                [(s.spec.name, s.offset, s.rows) for s in g.slots])
            for d, g in groups.items()}


@pytest.mark.parametrize("fused_storage", [True, False])
@pytest.mark.parametrize("num_shards", [1, 4])
@pytest.mark.parametrize("name,rows", LAYOUT_CASES,
                         ids=[c[0] for c in LAYOUT_CASES])
def test_collection_layout_matches_reference(name, rows, num_shards,
                                             fused_storage):
    jspecs, tspecs = _specs(rows)
    jc = JENG.EmbeddingCollection(jspecs, num_shards,
                                  fused_storage=fused_storage)
    tc = TENG.EmbeddingCollection(tspecs, num_shards,
                                  fused_storage=fused_storage)
    assert [t.name for t in tc.replicated] == [t.name for t in jc.replicated]
    assert _groups(tc.groups) == _groups(jc.groups)
    assert _groups(tc.local_groups) == _groups(jc.local_groups)
    for which in ("all", "replicated"):
        assert tc.fused_entries(which) == jc.fused_entries(which)
    assert [(g.name, g.total_rows) for g, _ in tc._local_units(
        _param_shapes(tc))] == [(g.name, g.total_rows) for g, _ in
                                jc._local_units(_param_shapes(tc))]


def _param_shapes(coll):
    """A params stand-in keyed like ``init()`` (the layout tests need the
    keys only, not gigabytes of rows)."""
    keys = [g.name for g in coll.groups.values()]
    keys += ([g.name for g in coll.local_groups.values()]
             if coll.fused_storage else [t.name for t in coll.replicated])
    return {k: None for k in keys}


def _features(rng, specs, B, frac_invalid=0.3):
    feats = {}
    for t in specs:
        ids = rng.integers(0, t.vocab_size, size=(B, t.max_valency))
        ids[rng.random(ids.shape) < frac_invalid] = -1
        feats[t.name] = ids.astype(np.int32)
    return feats


def _setup(name, num_shards=1, fused_storage=True, B=5, seed=0):
    jspecs, tspecs = _specs(TABLE_LISTS[name])
    jc = JENG.EmbeddingCollection(jspecs, num_shards,
                                  fused_storage=fused_storage)
    tc = TENG.EmbeddingCollection(tspecs, num_shards,
                                  fused_storage=fused_storage)
    params = jax.tree.map(np.asarray, jc.init(jax.random.PRNGKey(seed)))
    feats = _features(np.random.default_rng(seed), jspecs, B)
    return jc, tc, params, feats


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


@pytest.mark.parametrize("name", ["one_dim", "mixed", "unsorted"])
def test_fused_plan_matches_reference(name):
    jc, tc, params, feats = _setup(name)
    jslots, slots, means = jc._fused_plan({k: jnp.asarray(v) for k, v
                                           in feats.items()})
    plan = tc._fused_plan(_t(feats))
    assert plan.fslots == [TENG.FusedSlot(*dataclasses.astuple(s))
                           for s in jslots]
    # the kernel's slot table names the same spans and combiners
    assert [(a, b) for _, a, b, _ in plan.slot_table] == \
        [s.cols for s in jslots]
    assert [m for *_, m in plan.slot_table] == np.asarray(means).tolist()
    assert len(plan.col_offsets) == np.asarray(slots).shape[0]


def _fused_case(rng, dims, spec, B):
    """Row spaces of ``dims`` and a slot table from ``spec``: (group,
    valency, mean) per slot; ids uniform in [-1, rows)."""
    groups = [rng.standard_normal((int(rng.integers(3, 40)), d)
                                  ).astype(np.float32) for d in dims]
    slots, cols, c0 = [], [], 0
    for g, w, mean in spec:
        slots.append((g, c0, c0 + w, mean))
        cols.append(rng.integers(-1, groups[g].shape[0], size=(B, w)))
        c0 += w
    rows = np.concatenate(cols, axis=1).astype(np.int32)
    return groups, rows, np.asarray(slots, np.int32)


def _edge_rows(rows, slots):
    """The edge cases of the card's check: a mean slot with count 0, a
    sum slot of -1s, one row repeated over a span, a sample with no id."""
    rows = rows.copy()
    (_, a0, b0, _), (_, a1, b1, _) = slots[0], slots[1]
    rows[0, a0:b0] = -1
    rows[0, a1:b1] = -1
    rows[1, a1:b1] = 2
    rows[2, :] = -1
    return rows


def _absolute(groups, rows, slots, dmax):
    """The reference's layout: one padded (R, dmax) table, absolute ids,
    the (S,) slot stream and (K,) mean flags."""
    bases = np.cumsum([0] + [g.shape[0] for g in groups[:-1]])
    table = np.concatenate([np.pad(g, ((0, 0), (0, dmax - g.shape[1])))
                            for g in groups])
    absr = rows.copy()
    stream = np.zeros(rows.shape[1], np.int32)
    for k, (g, a, b, _) in enumerate(slots):
        absr[:, a:b] = np.where(rows[:, a:b] >= 0, rows[:, a:b] + bases[g], -1)
        stream[a:b] = k
    return (jnp.asarray(table), jnp.asarray(absr), jnp.asarray(stream),
            jnp.asarray(slots[:, 3]))


FUSED_CASES = {               # dims, (group, valency, mean) per slot, B
    # every published dlrm0 width, a 128-wide span, valency 1
    "all_dims": ((32, 64, 96, 128, 192, 256),
                 [(0, 3, 1), (1, 2, 0), (2, 1, 0), (3, 128, 1), (4, 4, 0),
                  (5, 2, 1)], 3),
    "one_group": ((8,), [(0, 4, 0), (0, 4, 1), (0, 1, 1)], 4),
    "interleaved": ((8, 16), [(1, 1, 1), (0, 5, 1), (1, 2, 0), (0, 17, 0)],
                    3),
}


@pytest.mark.parametrize("case", list(FUSED_CASES))
@pytest.mark.parametrize("edges", [False, True])
def test_fused_lookup_ref_matches_pallas_and_oracle(case, edges):
    dims, spec, B = FUSED_CASES[case]
    rng = np.random.default_rng(len(spec) + 10 * B)
    groups, rows, slots = _fused_case(rng, dims, spec, B)
    if edges:
        rows = _edge_rows(rows, slots)
    dmax = max(dims)
    got = TREF.fused_lookup_ref([torch.from_numpy(g) for g in groups],
                                torch.from_numpy(rows),
                                torch.from_numpy(slots), dmax)
    table, absr, stream, means = _absolute(groups, rows, slots, dmax)
    _close(got, JREF.fused_lookup_ref(table, absr, stream, means))
    _close(got, fused_lookup_kernel_call(table, absr, stream, means,
                                         interpret=True))
    if edges:                      # no valid id: a zero vector, mean or sum
        assert not got[0, :2].any() and not got[2].any()


def test_fused_lookup_ref_pads_lanes_with_zeros():
    rng = np.random.default_rng(3)
    groups, rows, slots = _fused_case(rng, (8, 16), [(0, 3, 0), (1, 2, 1)],
                                      4)
    got = TREF.fused_lookup_ref([torch.from_numpy(g) for g in groups],
                                torch.from_numpy(rows),
                                torch.from_numpy(slots), 32)
    assert got.shape == (4, 2, 32)
    assert not got[:, 0, 8:].any() and not got[:, 1, 16:].any()


@pytest.mark.parametrize("V,D,B,Vl", [(50, 8, 3, 5), (7, 32, 4, 1),
                                      (300, 16, 2, 40)])
def test_gather_ref_matches_pallas(V, D, B, Vl):
    rng = np.random.default_rng(V)
    table = rng.standard_normal((V, D)).astype(np.float32)
    ids = rng.integers(-1, V, size=(B, Vl)).astype(np.int32)
    ids[0] = -1
    got = TREF.embedding_gather_ref(torch.from_numpy(table),
                                    torch.from_numpy(ids))
    want = gather_kernel_call(jnp.asarray(table), jnp.asarray(ids),
                              interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(JREF.embedding_gather_ref(
            jnp.asarray(table), jnp.asarray(ids))))


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("name,num_shards,fused_storage", [
    ("one_dim", 1, True), ("mixed", 1, True), ("unsorted", 1, True),
    ("mixed", 1, False), ("big", 4, True)])
def test_lookup_matches_reference_kernel_path(name, num_shards,
                                              fused_storage, fused,
                                              monkeypatch):
    jc, tc, params, feats = (_setup(name, num_shards, fused_storage)
                             if name != "big" else _big_setup(monkeypatch))
    want = jc.lookup({k: jnp.asarray(v) for k, v in params.items()},
                     {k: jnp.asarray(v) for k, v in feats.items()},
                     use_kernel=True, fused=fused)
    got = tc.lookup(_t(params), _t(feats), fused=fused)
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape
        _close(got[k], want[k])


def _big_setup(monkeypatch):
    """Sharded width-groups (4 shards, no mesh: the reference reads them
    locally); the tables stay small because the planner's replication
    threshold is set to 0 in both frameworks."""
    rows = [("huge", 3000, 8, 1.0, 1, "sum"), ("mid", 700, 16, 2.0, 4, "mean"),
            ("small", 100, 16, 1.0, 2, "sum"), ("h2", 2001, 8, 3.0, 8, "mean")]
    jspecs, tspecs = _specs(rows)
    monkeypatch.setattr(JSH, "REPLICATE_BYTES", 0)
    monkeypatch.setattr(TSH, "REPLICATE_BYTES", 0)
    jc = JENG.EmbeddingCollection(jspecs, 4, fused_storage=True)
    tc = TENG.EmbeddingCollection(tspecs, 4, fused_storage=True)
    assert jc.groups and _groups(tc.groups) == _groups(jc.groups)
    params = jax.tree.map(np.asarray, jc.init(jax.random.PRNGKey(1)))
    return jc, tc, params, _features(np.random.default_rng(1), jspecs, 4)


@pytest.mark.parametrize("name", ["one_dim", "mixed"])
def test_group_fused_lookup_and_reference_match_jax(name):
    jc, tc, params, feats = _setup(name)
    jp, tp = ({k: jnp.asarray(v) for k, v in params.items()}, _t(params))
    jf, tf = ({k: jnp.asarray(v) for k, v in feats.items()}, _t(feats))
    for dim, g in tc.local_groups.items():
        got = TENG._group_fused_lookup(tp[g.name], g, tf)
        want = JENG._group_fused_lookup(jp[g.name], jc.local_groups[dim], jf)
        for k in want:
            _close(got[k], want[k])
    tmat, jmat = (TENG.materialize_tables(tc, tp),
                  JENG.materialize_tables(jc, jp))
    for k in jmat:
        np.testing.assert_array_equal(tmat[k].numpy(), np.asarray(jmat[k]))
    got = TENG.lookup_reference(tmat, tc.tables, tf)
    want = JENG.lookup_reference(jmat, jc.tables, jf)
    for k in want:
        _close(got[k], want[k])


def test_fused_table_equals_reference_copy():
    jc, tc, params, _ = _setup("mixed")
    np.testing.assert_array_equal(
        tc.fused_table(_t(params)).numpy(),
        np.asarray(jc.fused_table({k: jnp.asarray(v)
                                   for k, v in params.items()})))


@pytest.mark.parametrize("fused", [True, False])
def test_cpu_lookup_gradients_match_jax(fused):
    """The plain versions stay differentiable: d(sum of squares)/d(tables)
    equals jax.grad through the reference's lookup."""
    jc, tc, params, feats = _setup("mixed")
    jf = {k: jnp.asarray(v) for k, v in feats.items()}

    def jloss(p):
        o = jc.lookup(p, jf, fused=fused)
        return sum(jnp.sum(v ** 2) for v in o.values())

    jg = jax.grad(jloss)({k: jnp.asarray(v) for k, v in params.items()})
    tp = {k: v.requires_grad_(True) for k, v in _t(params).items()}
    out = tc.lookup(tp, _t(feats), fused=fused)
    sum((v ** 2).sum() for v in out.values()).backward()
    for k in jg:
        _close(tp[k].grad, jg[k])


def test_init_layout_and_distribution():
    _, tc, _, _ = _setup("mixed")
    p = tc.init(torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in p.items()} == {
        g.name: (g.total_rows, d) for d, g in tc.local_groups.items()}
    allv = torch.cat([v.reshape(-1) for v in p.values()])
    assert allv.dtype == torch.float32
    assert abs(allv.std().item() - 0.01) < 0.001
    q = tc.init(torch.Generator().manual_seed(0))
    assert all(torch.equal(p[k], q[k]) for k in p)


def test_unported_paths_name_their_roadmap_item():
    """The distributed methods and the hot-id cache are ported (the ranked
    paths: tests/test_torch_sharded_embeddings.py).  On ``LOCAL`` they
    give the one-device lookup bitwise, as the reference's ``local_only``
    branch does; the executor constructs; an unknown method still
    raises."""
    _, tc, params, feats = _setup("one_dim")
    tp, tf = _t(params), _t(feats)
    want = tc.lookup(tp, tf)
    for method in ("psum", "a2a", "local"):
        got = tc.lookup(tp, tf, method=method)
        assert all(torch.equal(got[k], want[k]) for k in want)
    cache = TCACHE.HotIdCache(capacity=4)
    got = tc.lookup(tp, tf, method="a2a", cache=cache)
    assert all(torch.equal(got[k], want[k]) for k in want)
    ex = TENG.PipelinedEmbeddingExecutor(tc, cache=cache)
    ex.step(tp, tf)
    got = ex.lookup(tp, tf)
    assert all(torch.equal(got[k], want[k]) for k in want)
    with pytest.raises(ValueError, match="method"):
        tc.lookup(tp, tf, method="nope")


def test_ops_sends_cpu_tensors_to_plain_versions():
    rng = np.random.default_rng(5)
    groups, rows, slots = _fused_case(rng, (8, 16), [(0, 3, 0), (1, 2, 1)], 4)
    g = [torch.from_numpy(x) for x in groups]
    r, s = torch.from_numpy(rows), torch.from_numpy(slots)
    assert torch.equal(TOPS.fused_lookup(g, r, s, 16),
                       TREF.fused_lookup_ref(g, r, s, 16))
    assert torch.equal(TOPS.embedding_gather(g[0], r),
                       TREF.embedding_gather_ref(g[0], r))
    # the wrappers themselves launch or raise: never compute on the CPU
    with pytest.raises(ValueError, match="CUDA"):
        TFL.fused_lookup(g, r, s, 16)
    with pytest.raises(ValueError, match="CUDA"):
        TEG.embedding_gather(g[0], r)
    gout = torch.ones((4, 2, 16))
    shapes = [tuple(x.shape) for x in g]
    cs = TREF.column_slots(s, r.shape[1]).int()
    assert all(torch.equal(a, b) for a, b in zip(
        TOPS.fused_scatter(gout, r, s, cs, shapes),
        TREF.fused_scatter_ref(gout, r, s, shapes)))
    with pytest.raises(ValueError, match="CUDA"):
        TFS.fused_scatter(gout, r, s, cs, shapes)
    # the single-table lookup, the scatter of deduplicated ids and the
    # int8 fused lookup
    ids = torch.tensor([[0, -1, 2], [-1, -1, -1], [1, 1, 5]],
                       dtype=torch.int32)
    for comb in ("sum", "mean"):
        assert torch.equal(TOPS.embedding_lookup(g[1], ids, comb),
                           TREF.embedding_lookup_ref(g[1], ids, comb))
        with pytest.raises(ValueError, match="CUDA"):
            TEL.embedding_lookup(g[1], ids, comb)
    uniq = torch.tensor([0, 3, 4, -1], dtype=torch.int32)
    grads = torch.ones((4, 16))
    assert torch.equal(TOPS.embedding_scatter(grads, uniq, 6),
                       TREF.embedding_scatter_ref(grads, uniq, 6))
    with pytest.raises(ValueError, match="CUDA"):
        TES.embedding_scatter(grads, uniq, 6)
    qts = [TQ.quantize_row_space(x) for x in g]
    qg, qs = [q.q for q in qts], [q.scale for q in qts]
    assert torch.equal(TOPS.fused_lookup_q(qg, qs, r, s, 16),
                       TREF.fused_lookup_q_ref(qg, qs, r, s, 16))
    with pytest.raises(ValueError, match="CUDA"):
        TFL.fused_lookup_q(qg, qs, r, s, 16)
    assert TFL.launches == 0 and TEG.launches == 0 and TFS.launches == 0
    assert TEL.launches == 0 and TES.launches == 0 and TFL.launches_q == 0


# the fused scatter's cases: the lookup's, plus widths 4 and 8 (the
# reduced config's) with rows that repeat across samples and slots
SCATTER_CASES = dict(FUSED_CASES, widths_4_8=(
    (4, 8), [(1, 3, 1), (0, 6, 0), (1, 1, 0), (0, 2, 1), (1, 9, 0)], 6))


def _scatter_close(got, want):
    for g, w in zip(got, want):
        w = np.asarray(w, np.float32)
        np.testing.assert_allclose(g.detach().numpy(), w, rtol=0,
                                   atol=SCATTER_RTOL * np.abs(w).max())


def _by_group(dtable, groups):
    """The reference's (R, dmax) gradient sliced back into row spaces."""
    dtable = np.asarray(dtable)
    bases = np.cumsum([0] + [g.shape[0] for g in groups[:-1]])
    return [dtable[b:b + g.shape[0], :g.shape[1]]
            for b, g in zip(bases, groups)]


@pytest.mark.parametrize("case", list(SCATTER_CASES))
@pytest.mark.parametrize("edges", [False, True])
def test_fused_scatter_ref_matches_pallas_and_oracle(case, edges):
    dims, spec, B = SCATTER_CASES[case]
    rng = np.random.default_rng(len(spec) + 7 * B)
    groups, rows, slots = _fused_case(rng, dims, spec, B)
    if edges:
        rows = _edge_rows(rows, slots)
    dmax = max(dims)
    gout = rng.standard_normal((B, len(spec), dmax)).astype(np.float32)
    got = TREF.fused_scatter_ref(torch.from_numpy(gout),
                                 torch.from_numpy(rows),
                                 torch.from_numpy(slots),
                                 [g.shape for g in groups])
    assert [tuple(x.shape) for x in got] == [g.shape for g in groups]
    _, absr, stream, _ = _absolute(groups, rows, slots, dmax)
    vocab = sum(g.shape[0] for g in groups)
    want = JREF.fused_scatter_ref(jnp.asarray(gout), absr, stream, vocab)
    _scatter_close(got, _by_group(want, groups))
    pallas = fused_scatter_kernel_call(jnp.asarray(gout), absr, stream,
                                       vocab, interpret=True)
    _scatter_close(got, _by_group(pallas, groups))
    # rows no valid id names stay zero
    for g, grad in zip(range(len(groups)), got):
        named = set()
        for gi, a, b, _ in slots:
            if gi == g:
                named |= set(rows[:, a:b][rows[:, a:b] >= 0].tolist())
        untouched = sorted(set(range(grad.shape[0])) - named)
        assert not grad[untouched].any()


@pytest.mark.parametrize("case", list(SCATTER_CASES))
def test_fused_lookup_gradient_matches_jax_vjp(case):
    """FusedLookup's backward (mean scaling, then the plain scatter)
    against jax.vjp of the reference's custom_vjp, whose backward runs
    the Pallas scatter in interpret mode, for a random cotangent."""
    dims, spec, B = SCATTER_CASES[case]
    rng = np.random.default_rng(100 + B)
    groups, rows, slots = _fused_case(rng, dims, spec, B)
    rows = _edge_rows(rows, slots)
    dmax = max(dims)
    ct = rng.standard_normal((B, len(spec), dmax)).astype(np.float32)
    table, absr, stream, means = _absolute(groups, rows, slots, dmax)
    want_out, vjp = jax.vjp(
        lambda t: JOPS.fused_lookup(t, absr, stream, means), table)
    (dtable,) = vjp(jnp.asarray(ct))
    tg = [torch.from_numpy(g).requires_grad_(True) for g in groups]
    r, s = torch.from_numpy(rows), torch.from_numpy(slots)
    out = TOPS.FusedLookup.apply(r, s, TREF.column_slots(s, r.shape[1]),
                                 dmax, *tg)
    _close(out, want_out)
    out.backward(torch.from_numpy(ct))
    for got, want in zip(tg, _by_group(dtable, groups)):
        _close(got.grad, want, atol=VJP_TOL, rtol=VJP_TOL)


def test_fused_lookup_gradient_skips_row_spaces_without_grad():
    rng = np.random.default_rng(9)
    groups, rows, slots = _fused_case(rng, (8, 16), [(0, 3, 1), (1, 2, 0)], 4)
    a = torch.from_numpy(groups[0]).requires_grad_(True)
    b = torch.from_numpy(groups[1])
    r, s = torch.from_numpy(rows), torch.from_numpy(slots)
    out = TOPS.FusedLookup.apply(r, s, TREF.column_slots(s, r.shape[1]), 16,
                                 a, b)
    out.sum().backward()
    assert a.grad is not None and a.grad.shape == a.shape
    assert b.grad is None


def test_a_plan_first_used_under_inference_mode_still_trains():
    """The collection caches its slot table per device; made first under
    inference_mode (scoring), it must still serve a training step."""
    _, tc, params, feats = _setup("mixed", seed=3)
    tf = _t(feats)
    with torch.inference_mode():
        tc.lookup(_t(params), tf)
    tp = {k: v.requires_grad_(True) for k, v in _t(params).items()}
    sum(v.sum() for v in tc.lookup(tp, tf).values()).backward()
    assert all(v.grad is not None for v in tp.values())


def test_plan_caches_the_column_slots():
    """The fused plan's cached (S,) column -> slot table, which the card's
    scatter reads, is the plain version's `column_slots` of its slot
    table."""
    _, tc, params, feats = _setup("mixed", seed=4)
    plan, _, rows, slots = tc.fused_inputs(_t(params), _t(feats))
    col_slot = plan.on(rows.device)[2]
    assert col_slot.dtype == torch.int32
    assert torch.equal(col_slot.long(),
                       TREF.column_slots(slots, rows.shape[1]))
    assert plan.on(rows.device)[2] is col_slot
