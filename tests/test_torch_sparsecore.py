"""The rest of the SparseCore kernels' plain versions in the port, and the
per-table training route, against the JAX package on the CPU:

  * ``models/quant.py``: `quantize` and `quantize_row_space` bitwise
    against the reference's ``quantize`` (the row-space layout against
    the real lanes of the padded (R, 256) fused table's quantisation);
  * ``embeddings/dedup.py``: `dedup_ids` bitwise against the reference;
  * ``ref.embedding_lookup_ref`` against the Pallas ``lookup_kernel_call``
    in interpret mode and the reference's oracle;
  * ``ref.embedding_scatter_ref`` bitwise against the Pallas
    ``scatter_kernel_call`` for unique ids, and its adjacent-duplicate
    contract against ``.at[].add``;
  * the fused scatter's sort keys (``kernels/fused_scatter.py``): int32
    for every dlrm0 cut, int64 from 2^31 - 1 rows, and the plain key
    kernel and key decoding against numpy;
  * ``ref.fused_lookup_q_ref`` against the reference's
    ``ops.fused_lookup_q`` over ``quantize(fused_table)``, at every dlrm0
    width on reduced dlrm0's descriptors;
  * ``ops.GatherRows`` (the per-table route's gradient) and the train
    step with ``ParallelConfig(emb_pipeline=False)`` against the
    reference's ``make_train_step`` with the same flag.

Inputs come from numpy seeds.  Tolerances: the lookup adds a sample's
rows in other orders than the Pallas grid: LOOKUP_TOL = 2e-5 (as
``tests/test_torch_embeddings.py``); the int8 lookup as
``tests/test_quantization.py``: Q_ATOL = 2e-6, Q_RTOL = 1e-5; the scatter
of unique ids is a copy (0 + g) and is bitwise; adjacent duplicates are
summed in index order by the port and by ``.at[].add`` in XLA's order:
DUP_TOL = 1e-6.  Gradients and the loss curve use the bars of
``tests/test_torch_train.py``.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs import registry as JREG
from repro.configs.base import EmbeddingTableConfig as JTable
from repro.configs.base import OptimizerConfig as JOpt
from repro.configs.base import ParallelConfig as JPar
from repro.configs.base import ShapeConfig as JShape
from repro.data.synthetic import Dataset as JDataset
from repro.embeddings import dedup as JDEDUP
from repro.embeddings import engine as JENG
from repro.kernels import ops as JOPS
from repro.kernels import ref as JREF
from repro.kernels.embedding_grad import scatter_kernel_call
from repro.kernels.embedding_lookup import lookup_kernel_call
from repro.launch import steps as JSTEPS
from repro.models import api as JAPI
from repro.models import quant as JQ
from repro.optim import adam as JOPT
from repro.parallel.context import LOCAL
from repro_torch import interop
from repro_torch.configs import dlrm0
from repro_torch.configs import registry as TREG
from repro_torch.configs.base import EmbeddingTableConfig as TTable
from repro_torch.configs.base import OptimizerConfig as TOpt
from repro_torch.configs.base import ParallelConfig as TPar
from repro_torch.configs.base import RunConfig as TRun
from repro_torch.configs.base import ShapeConfig as TShape
from repro_torch.embeddings import dedup as TDEDUP
from repro_torch.embeddings import engine as TENG
from repro_torch.kernels import fused_scatter as TFS
from repro_torch.kernels import ops as TOPS
from repro_torch.kernels import ref as TREF
from repro_torch.launch import steps as TSTEPS
from repro_torch.models import dlrm as TDL
from repro_torch.models import quant as TQ
from repro_torch.optim import adam as TOPT
from repro_torch.train.trainer import Trainer, TrainerState

DLRM0_DIMS = (32, 64, 96, 128, 192, 256)
LOOKUP_TOL = 2e-5
Q_ATOL, Q_RTOL = 2e-6, 1e-5
DUP_TOL = 1e-6
GRAD_REL_TOL = 2.0 ** -5


def _bits(x):
    return np.asarray(x).view(np.int32)


# -- quantisation ---------------------------------------------------------------

@pytest.mark.parametrize("shape,tile", [((50, 256), 128), ((7, 3, 96), 32),
                                        ((40, 192), 128), ((9, 5), 128)])
def test_quantize_is_bitwise_the_reference(shape, tile):
    rng = np.random.default_rng(sum(shape) + tile)
    w = (rng.standard_normal(shape) * rng.choice(
        [1e-3, 1.0, 40.0], size=shape[:-1] + (1,))).astype(np.float32)
    w[..., 0, :] = 0.0                      # an all-zero row: the 1e-12 floor
    want = JQ.quantize(jnp.asarray(w), tile)
    got = TQ.quantize(torch.from_numpy(w), tile)
    assert got.tile == want.tile and got.q.dtype == torch.int8
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(_bits(got.scale.numpy()),
                                  _bits(want.scale))
    np.testing.assert_array_equal(
        got.dequant(torch.float32).numpy(),
        np.asarray(want.dequant(jnp.float32)))
    assert got.nbytes == want.nbytes and got.shape == want.shape


@pytest.mark.parametrize("D", DLRM0_DIMS)
def test_quantize_row_space_is_the_padded_fused_tables_lanes(D, monkeypatch):
    """A d{D} row space's int8 values and scales equal the real lanes and
    the first ceil(D / 128) scales of the reference's quantisation of the
    row space padded to 256 lanes (the fused table's layout)."""
    rng = np.random.default_rng(D)
    w = (rng.standard_normal((333, D)) * rng.choice(
        [1e-4, 0.01, 1.0, 25.0], size=(333, 1))).astype(np.float32)
    w[3] = 0.0
    want = JQ.quantize(jnp.asarray(np.pad(w, ((0, 0), (0, 256 - D)))), 128)
    monkeypatch.setattr(TQ, "BLOCK_ROWS", 100)    # several blocks, one partial
    got = TQ.quantize_row_space(torch.from_numpy(w), 128)
    nt = -(-D // 128)
    assert tuple(got.scale.shape) == (333, nt)
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q)[:, :D])
    np.testing.assert_array_equal(_bits(got.scale.numpy()),
                                  _bits(np.asarray(want.scale)[:, :nt]))
    np.testing.assert_array_equal(
        got.dequant(torch.float32).numpy(),
        np.asarray(want.dequant(jnp.float32))[:, :D])


# -- dedup ------------------------------------------------------------------------

@pytest.mark.parametrize("n,hi,seed", [(200, 50, 0), (64, 10_000, 1),
                                       (17, 3, 2), (8, 5, 3)])
def test_dedup_ids_is_bitwise_the_reference(n, hi, seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(-1, hi, size=n).astype(np.int32)
    if seed == 3:
        ids[:] = -1                         # nothing valid
    ju, ji, jn = JDEDUP.dedup_ids(jnp.asarray(ids))
    tu, ti, tn = TDEDUP.dedup_ids(torch.from_numpy(ids))
    valid = ids >= 0
    assert tu.dtype == ti.dtype == tn.dtype == torch.int32
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    np.testing.assert_array_equal(ti.numpy()[valid], np.asarray(ji)[valid])
    assert int(tn) == int(jn)
    np.testing.assert_array_equal(tu.numpy()[ti.numpy()[valid]], ids[valid])
    assert float(TDEDUP.dedup_ratio(torch.from_numpy(ids))) == \
        float(JDEDUP.dedup_ratio(jnp.asarray(ids)))


# -- kernel 7: the single-table lookup ------------------------------------------

@pytest.mark.parametrize("combiner", ["sum", "mean"])
@pytest.mark.parametrize("V,D,B,Vl", [(8192, 64, 6, 16), (100, 32, 4, 9),
                                      (50, 256, 3, 1), (30, 8, 5, 40)])
def test_embedding_lookup_ref_matches_pallas_and_oracle(combiner, V, D, B,
                                                        Vl):
    rng = np.random.default_rng(V + D + Vl)
    table = rng.standard_normal((V, D)).astype(np.float32)
    ids = rng.integers(-1, V, size=(B, Vl)).astype(np.int32)
    ids[0] = -1                              # a sample with no valid id
    got = TREF.embedding_lookup_ref(torch.from_numpy(table),
                                    torch.from_numpy(ids), combiner)
    assert got.shape == (B, D) and got.dtype == torch.float32
    assert not got[0].any()
    jt, ji = jnp.asarray(table), jnp.asarray(ids)
    for want in (lookup_kernel_call(jt, ji, combiner=combiner,
                                    interpret=True),
                 JREF.embedding_lookup_ref(jt, ji, combiner)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=LOOKUP_TOL, rtol=LOOKUP_TOL)
    with pytest.raises(ValueError, match="combiner"):
        TREF.embedding_lookup_ref(torch.from_numpy(table),
                                  torch.from_numpy(ids), "max")


# -- kernel 8: the scatter of deduplicated ids ----------------------------------

def _unique_ids(rng, V, N, n_live):
    uids = np.sort(rng.permutation(V)[:n_live]).astype(np.int32)
    return np.concatenate([uids, np.full(N - n_live, -1, np.int32)])


@pytest.mark.parametrize("V,D,N,n_live", [(32, 8, 10, 5), (128, 64, 40, 40),
                                          (64, 16, 64, 0), (500, 256, 9, 7)])
def test_embedding_scatter_ref_is_bitwise_pallas_for_unique_ids(V, D, N,
                                                                n_live):
    rng = np.random.default_rng(V + N)
    ids = _unique_ids(rng, V, N, n_live)
    grads = rng.standard_normal((N, D)).astype(np.float32)
    got = TREF.embedding_scatter_ref(torch.from_numpy(grads),
                                     torch.from_numpy(ids), V)
    for want in (scatter_kernel_call(jnp.asarray(grads), jnp.asarray(ids), V,
                                     interpret=True),
                 JREF.embedding_scatter_ref(jnp.asarray(grads),
                                            jnp.asarray(ids), V)):
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


def test_embedding_scatter_ref_sums_adjacent_duplicates_in_order():
    """A sorted stream with runs of equal ids, a -1 tail and an id past V:
    each run's rows summed in index order (bitwise a sequential sum),
    within DUP_TOL of the reference's ``.at[].add``; -1 and id >= V add
    nothing."""
    rng = np.random.default_rng(7)
    V, D = 40, 16
    ids = np.sort(rng.integers(0, V, size=300)).astype(np.int32)
    ids = np.concatenate([ids, [V, V + 3], np.full(20, -1)]).astype(np.int32)
    grads = rng.standard_normal((ids.size, D)).astype(np.float32)
    got = TREF.embedding_scatter_ref(torch.from_numpy(grads),
                                     torch.from_numpy(ids), V).numpy()
    seq = np.zeros((V, D), np.float32)
    for i, g in zip(ids, grads):
        if 0 <= i < V:
            seq[i] = seq[i] + g
    np.testing.assert_array_equal(_bits(got), _bits(seq))
    want = JREF.embedding_scatter_ref(jnp.asarray(grads), jnp.asarray(ids), V)
    np.testing.assert_allclose(got, np.asarray(want), atol=DUP_TOL,
                               rtol=DUP_TOL)


def test_dedup_output_is_the_scatters_input_contract():
    """scatter(grad[uniq], uniq) restores a gradient that is zero off the
    named rows, bitwise: what ``chip_smoke.py`` checks at full width."""
    rng = np.random.default_rng(8)
    V, D = 300, 32
    ids = rng.integers(-1, V, size=(16, 9)).astype(np.int32)
    grad = np.zeros((V, D), np.float32)
    named = np.unique(ids[ids >= 0])
    grad[named] = rng.standard_normal((named.size, D)).astype(np.float32)
    uniq, _, num = TDEDUP.dedup_ids(torch.from_numpy(ids.reshape(-1)))
    g = torch.from_numpy(grad)
    got = TOPS.embedding_scatter(g[uniq.clamp_min(0).long()], uniq, V)
    assert int(num) == named.size
    assert torch.equal(got, g)


# -- kernel 5: the fused scatter's sort keys ----------------------------------

def _dlrm0_row_spaces(target_params):
    """(rows, dim) of dlrm0's row spaces: the published tables (None) or
    the vocabularies cut to ``target_params`` f32 parameters."""
    cfg = TREG.get_config("dlrm0")
    if target_params is not None:
        cfg = cfg.replace(dlrm=dataclasses.replace(
            cfg.dlrm, tables=dlrm0._table_specs(target_params=target_params)))
    coll = TDL.collection_for(cfg)
    return [(g.total_rows, d) for d, g in sorted(coll.local_groups.items())]


@pytest.mark.parametrize("target", [4_000_000_000, 12_000_000_000, None],
                         ids=["train_cut", "score_cut", "published"])
def test_fused_scatter_keys_are_int32_for_dlrm0(target):
    """dlrm0's training cut, scoring cut and published tables: int32 keys,
    the key of row 0 of each row space the rows before it."""
    shapes = _dlrm0_row_spaces(target)
    assert len(shapes) == 6
    assert not TFS.wide_keys(shapes)
    assert TFS.key_firsts(shapes) == np.cumsum(
        [0] + [r for r, _ in shapes[:-1]]).tolist()


def test_fused_scatter_keys_widen_at_2_31_rows():
    """int64 keys once the rows of all row spaces reach 2^31 - 1 (the int32
    key of an invalid descriptor); the same first keys either way."""
    assert not TFS.wide_keys([(2 ** 31 - 2, 32)])
    assert not TFS.wide_keys([(2 ** 30, 32), (2 ** 30 - 2, 64)])
    assert TFS.key_firsts([(2 ** 30, 32), (2 ** 30 - 2, 64)]) == [0, 2 ** 30]
    assert TFS.wide_keys([(2 ** 31 - 1, 32)])
    assert TFS.wide_keys([(2 ** 30, 32), (2 ** 30 - 1, 64)])
    assert TFS.wide_keys([(2 ** 31 - 1, 4)] * 6)
    assert TFS.key_firsts([(2 ** 31 - 1, 4)] * 3) == [0, 2 ** 31 - 1,
                                                      2 ** 32 - 2]


@pytest.mark.parametrize("seed", range(4))
def test_fused_scatter_key_encoding_round_trips(seed):
    """Random row spaces (1-128 of them; up to 2^23 rows each for seeds 0
    and 1, up to 2^31 - 1 for seeds 2 and 3), one slot of valency 2 each
    and a column no slot spans; ids in [-1, R_g + 2): the plain key kernel
    (``descriptor_keys``) against numpy's first_g + row at both widths (only
    int64 once the rows reach 2^31 - 1), invalid descriptors at the type's
    max; then ``split_keys`` gives each valid key's (g, row) back."""
    rng = np.random.default_rng(seed)
    G, B = int(rng.integers(1, 129)), 16
    R = rng.integers(1, 2 ** 23 if seed < 2 else 2 ** 31, size=G)
    shapes = [(int(r), int(d)) for r, d in
              zip(R, 4 * rng.integers(1, 65, size=G))]
    slots = np.array([(g, 2 * g, 2 * g + 2, 0) for g in range(G)], np.int32)
    rows = np.concatenate([rng.integers(-1, R[g] + 2, size=(B, 2))
                           for g in range(G)] + [np.zeros((B, 1))], 1)
    rows = rows.astype(np.int32)
    col_slot = TREF.column_slots(torch.from_numpy(slots), 2 * G + 1).int()
    g = np.append(np.repeat(np.arange(G), 2), -1)[None, :].repeat(B, 0)
    valid = (g >= 0) & (rows >= 0) & (rows < R[np.maximum(g, 0)])
    first = np.cumsum(np.append(0, R))[np.maximum(g, 0)]
    assert TFS.wide_keys(shapes) == (R.sum() >= 2 ** 31 - 1)
    for wide, none in ((False, 2 ** 31 - 1), (True, 2 ** 63 - 1)):
        if TFS.wide_keys(shapes) and not wide:
            continue                    # int32 keys do not hold these rows
        want = np.where(valid, first + rows, none).reshape(-1)
        got = TFS.descriptor_keys(torch.from_numpy(rows),
                                  torch.from_numpy(slots), col_slot, shapes,
                                  wide)
        assert got.dtype == (torch.int64 if wide else torch.int32)
        np.testing.assert_array_equal(got.numpy(), want)
        gg, rr = TFS.split_keys(got[torch.from_numpy(valid.reshape(-1))],
                                shapes)
        np.testing.assert_array_equal(gg.numpy(), g[valid])
        np.testing.assert_array_equal(rr.numpy(), rows[valid])


# -- kernel 4q: the int8 fused lookup -------------------------------------------

def _reduced_at_dlrm0_widths():
    """Reduced dlrm0's tables (vocabularies, valencies, combiners) with
    dlrm0's width rule, dims[(i * 7) % 6]: one table of every width."""
    cfg = TREG.get_reduced("dlrm0")
    return [dataclasses.replace(t, dim=DLRM0_DIMS[(i * 7) % 6])
            for i, t in enumerate(cfg.dlrm.tables)]


def test_fused_lookup_q_ref_matches_reference_at_every_dlrm0_width():
    tables = _reduced_at_dlrm0_widths()
    assert sorted(t.dim for t in tables) == list(DLRM0_DIMS)
    jtables = [JTable(*dataclasses.astuple(t)) for t in tables]
    jc = JENG.EmbeddingCollection(jtables, 1, fused_storage=True)
    tc = TENG.EmbeddingCollection(tables, 1, fused_storage=True)
    params = jax.tree.map(np.asarray, jc.init(jax.random.PRNGKey(0)))
    shape = JShape("q", "train", 1, 32)
    cfg = JREG.get_reduced("dlrm0")
    cfg = cfg.replace(dlrm=dataclasses.replace(cfg.dlrm,
                                               tables=tuple(jtables)))
    batch = JDataset(cfg, shape, seed=3).batch(0)
    feats = {t.name: batch[f"cat_{t.name}"] for t in tables}
    # the reference: quantise the padded fused table, absolute ids
    jfeats = {k: jnp.asarray(v) for k, v in feats.items()}
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    fslots, slots, means = jc._fused_plan(jfeats)
    absr = jnp.concatenate([jnp.where(jfeats[s.name] >= 0,
                                      jfeats[s.name] + s.row_base, -1)
                            for s in fslots], axis=1)
    qt = JQ.quantize(jc.fused_table(jparams), 128)
    want = JOPS.fused_lookup_q(qt.q, qt.scale, absr, slots, means)
    # the port: one quantised row space per width, group-local ids
    tp = {k: torch.from_numpy(np.array(v)) for k, v in params.items()}
    plan, groups, rows, slot_t = tc.fused_inputs(
        tp, {k: torch.from_numpy(v) for k, v in feats.items()})
    qts = [TQ.quantize_row_space(g) for g in groups]
    got = TOPS.fused_lookup_q([q.q for q in qts], [q.scale for q in qts],
                              rows, slot_t, plan.dmax)
    assert got.shape == tuple(want.shape) == (32, len(tables), 256)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=Q_ATOL,
                               rtol=Q_RTOL)
    # against the f32 lookup: within half a scale a row (the same lookup
    # of ones with half the scales) plus f32 rounding
    f32 = TOPS.fused_lookup(groups, rows, slot_t, plan.dmax)
    half = TOPS.fused_lookup_q([torch.ones_like(q.q) for q in qts],
                               [q.scale / 2 for q in qts], rows, slot_t,
                               plan.dmax)
    assert bool(((got - f32).abs() <= half + Q_ATOL + Q_RTOL * f32.abs()
                 ).all())


# -- step 0: the per-table route trains -------------------------------------------

def test_gather_rows_scatters_once_per_row_space(monkeypatch):
    """The per-table route's backward: one fused scatter per row space
    (not one gradient per table), equal to autograd through the plain
    gather; an id past its table reads and receives the table's last
    row."""
    rows = [("a", 20, 8, 3.0, 4, "sum"), ("b", 7, 8, 2.0, 3, "mean"),
            ("c", 11, 16, 1.0, 2, "sum")]
    coll = TENG.EmbeddingCollection([TTable(*r) for r in rows], 1,
                                    fused_storage=True)
    rng = np.random.default_rng(9)
    params = {k: torch.from_numpy(rng.standard_normal(tuple(v.shape)).astype(
        np.float32)).requires_grad_(True)
        for k, v in coll.init(torch.Generator().manual_seed(0)).items()}
    feats = {n: torch.from_numpy(rng.integers(-1, V + 2, size=(5, vl)).astype(
        np.int32)) for n, V, _, _, vl, _ in rows}
    calls = []
    real = TOPS.fused_scatter
    monkeypatch.setattr(TOPS, "fused_scatter",
                        lambda *a: calls.append(a[-1]) or real(*a))
    out = coll.lookup(params, feats, fused=False)
    ct = {k: torch.from_numpy(rng.standard_normal(tuple(v.shape)).astype(
        np.float32)) for k, v in out.items()}
    sum((out[k] * ct[k]).sum() for k in out).backward()
    assert sorted(calls) == sorted([[tuple(p.shape)] for p in
                                    params.values()])
    # autograd through the plain gather of each table's clipped ids
    for key, p in params.items():
        leaf = p.detach().clone().requires_grad_(True)
        g = coll.local_groups[int(key.split("_d")[1])]
        total = 0.0
        for s in g.slots:
            view = leaf[s.offset:s.offset + s.rows]
            r = TREF.embedding_gather_ref(view, feats[s.spec.name])
            total = total + (TENG._combine(r, feats[s.spec.name],
                                           s.spec.combiner)
                             * ct[s.spec.name]).sum()
        total.backward()
        torch.testing.assert_close(p.grad, leaf.grad, atol=1e-6, rtol=1e-6)


@pytest.fixture(scope="module")
def dlrm():
    jcfg, tcfg = JREG.get_reduced("dlrm0"), TREG.get_reduced("dlrm0")
    jp = JAPI.init_params(jcfg, jax.random.PRNGKey(0))
    return dict(jcfg=jcfg, tcfg=tcfg, jp=jp,
                npp=jax.tree.map(np.asarray, jp), B=64,
                jctx=dataclasses.replace(LOCAL, emb_pipeline=False))


def test_per_table_first_step_gradients_match_jax(dlrm):
    jcfg, tcfg, B = dlrm["jcfg"], dlrm["tcfg"], dlrm["B"]
    nb = JDataset(jcfg, JShape("t", "train", 1, B)).batch(0)
    (jloss, _), jg = jax.value_and_grad(
        lambda p: JSTEPS.loss_fn(jcfg, p, nb, dlrm["jctx"]), has_aux=True)(
            dlrm["jp"])
    tp = interop.params_from_numpy(dlrm["npp"])
    metrics, tg = TSTEPS.value_and_grad(
        tcfg, TPar(remat="none", emb_pipeline=False), tp,
        {k: torch.from_numpy(v) for k, v in nb.items()})
    assert abs(metrics["loss"].item() - float(jloss)) <= \
        1e-3 + 2.0 ** -7 * abs(float(jloss))
    jl = jax.tree.leaves(jg)
    assert len(tg) == len(jl)
    for got, want in zip(tg, jl):
        want = np.asarray(want)
        assert got.shape == want.shape and got.dtype == torch.float32
        assert np.abs(got.numpy() - want).max() <= \
            GRAD_REL_TOL * np.abs(want).max()


def test_per_table_loss_curve_matches_jax_train_step(dlrm, monkeypatch):
    """5 steps of Trainer.train with ParallelConfig(emb_pipeline=False)
    against the reference's jitted train step with the same flag; the
    trainer takes the per-table route (one gather per table a step, never
    the fused lookup)."""
    jcfg, tcfg, B = dlrm["jcfg"], dlrm["tcfg"], dlrm["B"]
    ocfg = dict(lr=3e-3, warmup_steps=2)
    jpcfg = JPar(remat="none", emb_pipeline=False)
    jstep = jax.jit(JSTEPS.make_train_step(
        jcfg, JShape("t", "train", 1, B), jpcfg, JOpt(**ocfg), dlrm["jctx"]))
    jp, jo = dlrm["jp"], JOPT.init(JOpt(**ocfg), dlrm["jp"])
    want = []
    for s in range(5):
        jp, jo, m = jstep(jp, jo,
                          JDataset(jcfg, JShape("t", "train", 1, B)).batch(s))
        want.append(float(m["loss"]))
    gathers = []
    real = TOPS.embedding_gather
    monkeypatch.setattr(TOPS, "embedding_gather",
                        lambda t, i: gathers.append(i.shape) or real(t, i))
    def no_fused(*a, **k):
        raise AssertionError("the fused route ran")

    monkeypatch.setattr(TENG.EmbeddingCollection, "_lookup_fused", no_fused)
    run = TRun(model=tcfg, shape=TShape("t", "train", 1, B),
               parallel=TPar(remat="none", emb_pipeline=False),
               optimizer=TOpt(**ocfg))
    tr = Trainer(run, device="cpu")
    tp = interop.params_from_numpy(dlrm["npp"])
    state = tr.train(5, state=TrainerState(tp, TOPT.init(run.optimizer, tp),
                                           0), log_every=1)
    got = [m["loss"] for m in tr.metrics_log]
    for g, w in zip(got, want):
        assert abs(g - w) <= 1e-3 + 2.0 ** -7 * abs(w), (got, want)
    assert state.step == 5
    assert len(gathers) == 5 * len(tcfg.dlrm.tables)
