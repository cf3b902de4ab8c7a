"""Sharded embedding engine — the SparseCore execution model (§3.5) in
PyTorch on ``torch.distributed``.

Port of ``repro/embeddings/engine.py``: the grouped table storage, the
fused descriptor layout, the one-device lookups, and the row-sharded
dataflow over ranks,

  ids --dedup--> unique ids --all-to-all--> row owners --gather-->
  vectors --all-to-all--> requesters --combine--> dense activations

Storage
-------
Tables of the same width pack into one row space per width.  With
``fused_storage`` (the DLRM's layout) the locally resident tables live in
``local_d{D}`` row spaces; sharded width-groups (``num_shards > 1``) keep
their own ``group_d{D}`` row spaces.  Under a ranked context
(``parallel/context.py``) rank (d, m) holds shard m of every
``group_d{D}`` (rows [m * rps, (m + 1) * rps)) and every ``local_d{D}``
whole.

Fused lookup (``fused=True``, the default; JAX ``ctx.emb_pipeline``)
-----------------------------------------------------------------
One launch over every table.  The descriptor stream is

    rows  (B, S)  : group-LOCAL row id per (sample, descriptor column),
                    i.e. ``table offset in its row space + feature id``
    slots (K, 4)  : per output slot (table) its row space, its column
                    span [a, b) of ``rows`` and its combiner flag

The JAX kernel path reads one (R, Dmax) copy of every row space, lanes
padded to the widest dim and concatenated on each call
(``EmbeddingCollection.fused_table``); for dlrm0 that copy is as large as
the tables.  The port's kernel reads the row spaces where they lie, so
no copy is made; ``fused_table`` stays only as a tool for the tests.

Per-table lookup (``fused=False``; ``examples/train_dlrm.py --pergroup``)
----------------------------------------------------------------------
One row gather per table, then a masked sum or mean.  The gathers of the
tables that share a row space go through one ``ops.GatherRows``, so the
backward scatters once per row space into one row-space-sized gradient.

Kernels
-------
The JAX ``use_kernel`` flag is dropped: as in ``kernels/ops.py``, the
device of the tensors decides.  CUDA tensors go to the hand-written
kernels, CPU tensors to their plain versions (``kernels/ref.py``).  The
fused route runs through ``ops.FusedLookup``, the reference's
``custom_vjp``: the fused-lookup kernel forward, the fused-scatter kernel
backward, so gradients reach the ``local_d{D}`` row spaces where they
lie.  The per-table route runs through ``ops.GatherRows``: the row-gather
kernel forward (one launch per table), the fused-scatter kernel backward
(one launch per row space), both dispatched by device the same way.

Distributed dataflow
--------------------
With a context whose model axis has more than one rank, the locally
resident tables keep the fused lookup, and each sharded width-group is
exchanged in one of the reference's two modes:
  * ``a2a`` — the paper's path: this rank's ids deduplicated, sent to
    their row owners (the id all-to-all over the model axis), gathered
    there, sent back (the vector all-to-all), broadcast to every
    occurrence and combined locally (the reference's einsum combine is a
    fused lookup here, below).  A destination takes at most C =
    max(8, ceil(N / ms x capacity_factor)) ids, N the GLOBAL batch's ids
    of the group (the reference sizes it from the global array); ids
    whose rank in sorted order within their destination is >= C read
    back as zero vectors, as in the reference.  The reference exchanges
    C slots a destination, padded; the port exchanges the kept ids only
    (variable-length all-to-alls, as the SparseCore's), after a
    count exchange: the same values, fewer bytes.
  * ``psum`` — the model axis's ids gathered (the reference replicates
    them over it), each rank combines the rows it owns, the partial
    combinations are summed over the model axis and each rank keeps its
    own samples.  ``auto`` takes it for a group of concatenated valency
    <= 4.
Under a ranked context every feature holds this rank's samples: the
global batch split over (data, model) in rank order, as the reference's
sparse stage splits it (``P(batch_both)``).  ``emb_pipeline`` (or
``fused=True``) software-pipelines the groups of a mode
(``parallel/overlap.software_pipeline``): group k+1's exchange is started
(``async_op=True``) before group k's gather and combine wait on theirs;
the results are the per-group loop's, bit for bit.  ``emb_wire_bf16``
casts the vectors to bf16 before the exchange; after the a2a they are
widened back to f32 for the combine (the reference combines in bf16).

The exchanges' backwards are written out (``context.exchanged``): the
equal-split all-to-all's transpose is the same all-to-all on the
gradient, the psum's is an all-gather of the samples' gradients.  The
owner gather and the psum partial's gather go through ``ops.GatherRows``
(the row-gather kernel forward, the fused-scatter kernel backward, on the
card, into the shard's own row space).  The a2a broadcasts the received
vectors to their occurrences and combines them in one
``ops.FusedLookup`` over the received vectors (the fused-lookup kernel
forward, the fused-scatter kernel backward): each table's columns summed
in column order, the one-device fused lookup's sum, so the sharded
lookup gives its bits.  Every sum of the backward is in a fixed order,
so a step is bitwise repeatable.

A hot-id cache (``embeddings/cache.HotIdCache``) serves its rows locally
and keeps them out of the exchange; the cached lookup's backward runs the
uncached dataflow at full capacity (`_CachedLookup`), so no gradient
enters the snapshot and none is dropped.  ``PipelinedEmbeddingExecutor``
owns the cache's per-step bookkeeping.
"""
from __future__ import annotations

import bisect
import itertools
import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import EmbeddingTableConfig
from repro_torch.embeddings.cache import HotIdCache
from repro_torch.embeddings.dedup import dedup_ids
from repro_torch.embeddings.sharding import plan_placement
from repro_torch.kernels import ops
from repro_torch.parallel.context import LOCAL, ParallelContext, exchanged
from repro_torch.parallel.overlap import software_pipeline

# ---------------------------------------------------------------------------
# Group layout
# ---------------------------------------------------------------------------


@dataclass
class TableSlot:
    spec: EmbeddingTableConfig
    offset: int            # row offset inside the group array
    rows: int              # padded rows reserved


@dataclass
class Group:
    dim: int
    slots: List[TableSlot] = field(default_factory=list)
    total_rows: int = 0
    prefix: str = "group"   # "group" = row-sharded, "local" = replicated

    @property
    def name(self) -> str:
        return f"{self.prefix}_d{self.dim}"


def row_sharded(name: str) -> bool:
    """Whether the row space named ``name`` is a row-sharded width-group
    (``group_d{D}``; rank m of the model axis holds its m-th block of
    rows), not a replicated ``local_d{D}`` one."""
    return name.startswith("group_")


@dataclass(frozen=True)
class FusedSlot:
    """One output slot of the fused descriptor stream (= one table)."""
    name: str
    combiner: str
    dim: int
    row_base: int          # absolute row offset in the fused row space
    cols: Tuple[int, int]  # descriptor-column span [a, b)


@dataclass
class FusedPlan:
    """The descriptor layout for one set of feature widths: slots ordered
    by valency, the params key of each row space, and the kernel's
    ``slots`` table, per-column row offsets and per-column slot (host
    lists; `on` gives them as int32 tensors on a device, cached)."""
    fslots: List[FusedSlot]
    keys: List[str]                       # row space of each group index
    slot_table: List[Tuple[int, int, int, int]]   # (group, a, b, mean)
    col_offsets: List[int]                # (S,) table offset per column
    col_slot: List[int]                   # (S,) slot of each column
    dmax: int
    _dev: Dict[torch.device, Tuple[torch.Tensor, ...]] = \
        field(default_factory=dict)

    def on(self, device: torch.device) -> Tuple[torch.Tensor, ...]:
        """(slot table (K, 4), column offsets (S,), column slots (S,))."""
        if device not in self._dev:
            # normal tensors even when first asked for under inference_mode:
            # a later training step saves the slot tables for its backward
            with torch.inference_mode(False):
                self._dev[device] = (
                    torch.tensor(self.slot_table, dtype=torch.int32,
                                 device=device).reshape(-1, 4),
                    torch.tensor(self.col_offsets, dtype=torch.int32,
                                 device=device),
                    torch.tensor(self.col_slot, dtype=torch.int32,
                                 device=device))
        return self._dev[device]


class EmbeddingCollection:
    """Plans placement and owns the parameter layout for a set of tables.

    With ``fused_storage`` (the DLRM stack's layout) the locally resident
    (replicated) tables are packed into per-width ``local_d{D}`` row
    spaces, which the fused lookup reads directly.  Sharded width-groups
    keep their own per-dim row spaces either way.
    """

    def __init__(self, tables: Sequence[EmbeddingTableConfig],
                 num_shards: int, *, fused_storage: bool = False):
        self.tables = list(tables)
        self.num_shards = max(1, num_shards)
        self.fused_storage = fused_storage
        self.plan = plan_placement(tables, self.num_shards)
        self.replicated: List[EmbeddingTableConfig] = []
        self.groups: Dict[int, Group] = {}
        # deterministic order: big tables first within each group
        for t in sorted(tables, key=lambda t: -t.vocab_size * t.dim):
            if self.plan[t.name].strategy == "replicate":
                self.replicated.append(t)
                continue
            g = self.groups.setdefault(t.dim, Group(dim=t.dim))
            g.slots.append(TableSlot(t, g.total_rows, t.vocab_size))
            g.total_rows += t.vocab_size
        # pad every group to a multiple of num_shards
        for g in self.groups.values():
            g.total_rows += (-g.total_rows) % self.num_shards
        # fused_storage: locally-resident tables pack into per-width
        # "local_d{D}" row spaces (native lane width, no padding waste)
        self.local_groups: Dict[int, Group] = {}
        if fused_storage:
            for t in self.replicated:
                g = self.local_groups.setdefault(
                    t.dim, Group(dim=t.dim, prefix="local"))
                g.slots.append(TableSlot(t, g.total_rows, t.vocab_size))
                g.total_rows += t.vocab_size
        self._plans: Dict[tuple, FusedPlan] = {}

    # -- params -------------------------------------------------------------

    def init(self, gen: torch.Generator, device=None,
             keep=None) -> Dict[str, torch.Tensor]:
        """Every row space, N(0, 1) * 0.01 in f32 (the reference's
        distribution; other draws), on ``device`` (default: ``gen``'s).
        Each row space is drawn and scaled in place, so a large one never
        exists twice.  ``keep(name, space)``, if given, returns what to
        keep of each space (a rank's shard), before the next is drawn."""
        def draw(name, rows, dim):
            t = torch.empty((rows, dim), dtype=torch.float32,
                            device=gen.device if device is None else device)
            t = t.normal_(generator=gen).mul_(0.01)
            return t if keep is None else keep(name, t)

        params = {g.name: draw(g.name, g.total_rows, dim)
                  for dim, g in sorted(self.groups.items())}
        if self.fused_storage:
            params.update({g.name: draw(g.name, g.total_rows, dim)
                           for dim, g in sorted(self.local_groups.items())})
        else:
            params.update({t.name: draw(t.name, t.vocab_size, t.dim)
                           for t in self.replicated})
        return params

    def table_view(self, params, t: EmbeddingTableConfig) -> torch.Tensor:
        """Per-table (V, D) view of wherever the table's rows live."""
        if self.fused_storage and t.dim in self.local_groups:
            g = self.local_groups[t.dim]
            for s in g.slots:
                if s.spec.name == t.name:
                    return params[g.name][s.offset: s.offset + s.rows]
        return params[t.name]

    def _units(self, which: str = "all") -> List[Tuple[Group, str]]:
        """(width-group, its params key) in fused-row-space order: local
        width-groups (or bare replicated tables) by dim, then, for
        ``which="all"``, the sharded width-groups."""
        if self.fused_storage:
            units = [(g, g.name)
                     for dim, g in sorted(self.local_groups.items())]
        else:
            units = []
            for t in self.replicated:
                g = Group(dim=t.dim, prefix="local")
                g.slots.append(TableSlot(t, 0, t.vocab_size))
                g.total_rows = t.vocab_size
                units.append((g, t.name))
        if which == "all":
            units += [(g, g.name) for dim, g in sorted(self.groups.items())]
        return units

    def _local_units(self, params) -> List[Tuple[Group, torch.Tensor]]:
        """(width-group, its full row-space array) for the local set."""
        return [(g, params[key]) for g, key in self._units("replicated")]

    # -- fused descriptor layout --------------------------------------------

    def fused_entries(self, which: str = "all"
                      ) -> Tuple[List[Tuple[str, str, int, int]], int]:
        """(name, combiner, dim, row_base) per table + fused row count.

        Row bases follow ``fused_table``'s concatenation order.  ``which``:
        "all" (every table) or "replicated" (the locally resident set).
        """
        entries: List[Tuple[str, str, int, int]] = []
        base = 0
        for g, _ in self._units(which):
            for s in g.slots:
                entries.append((s.spec.name, s.spec.combiner, g.dim,
                                base + s.offset))
            base += g.total_rows
        return entries, base

    def fused_table(self, params, which: str = "all") -> torch.Tensor:
        """The selected storage as ONE (R, Dmax) row space, lanes padded —
        the layout the JAX Pallas kernel reads.  A copy of every table:
        for tests only; the port's lookups never build it."""
        units = self._units(which)
        dmax = max(g.dim for g, _ in units)
        return torch.cat([F.pad(params[key], (0, dmax - g.dim))
                          for g, key in units], dim=0)

    def _fused_plan(self, features, which: str = "all") -> FusedPlan:
        """The descriptor layout for ``features``' widths (cached).

        Slots are ordered by valency (descriptor-span width), as in the
        reference, so same-valency tables sit in contiguous runs."""
        key = (which, tuple(features[t.name].shape[1] for t in self.tables))
        if key in self._plans:
            return self._plans[key]
        units = self._units(which)
        # first fused row of each row space: a row base -> (space, offset)
        starts = list(itertools.accumulate(
            (g.total_rows for g, _ in units), initial=0))
        entries, _ = self.fused_entries(which)
        entries = sorted(entries, key=lambda e: features[e[0]].shape[1])
        fslots, table, col_off, col_slot = [], [], [], []
        c0 = 0
        for k, (name, comb, dim, row_base) in enumerate(entries):
            vl = features[name].shape[1]
            gi = bisect.bisect_right(starts, row_base) - 1
            fslots.append(FusedSlot(name, comb, dim, row_base, (c0, c0 + vl)))
            table.append((gi, c0, c0 + vl, int(comb == "mean")))
            col_off += [row_base - starts[gi]] * vl
            col_slot += [k] * vl
            c0 += vl
        plan = FusedPlan(fslots, [k for _, k in units], table, col_off,
                         col_slot, max((g.dim for g, _ in units), default=0))
        self._plans[key] = plan
        return plan

    def fused_inputs(self, params, features, which: str = "all"):
        """The fused lookup's arguments for ``features``: (plan, row
        spaces, rows (B, S) int32 group-local ids, slots (K, 4) int32)."""
        plan = self._fused_plan(features, which)
        ids = torch.cat([features[s.name] for s in plan.fslots], dim=1)
        slot_table, col_off, _ = plan.on(ids.device)
        rows = torch.where(ids >= 0, ids + col_off, -1).to(torch.int32)
        return plan, [params[k] for k in plan.keys], rows, slot_table

    def _lookup_fused(self, params, features, *, which: str = "all"
                      ) -> Dict[str, torch.Tensor]:
        """One descriptor-stream launch over every selected table."""
        if not self._fused_plan(features, which).fslots:
            return {}
        plan, groups, rows, slots = self.fused_inputs(params, features, which)
        out3 = ops.FusedLookup.apply(rows, slots, plan.on(rows.device)[2],
                                     plan.dmax, *groups)
        # unbind, then slice: the backward stacks (B, dmax) slot gradients
        # once instead of one (B, K, dmax) zero buffer per table
        cols = out3.unbind(1)
        return {s.name: cols[i][:, :s.dim]
                for i, s in enumerate(plan.fslots)}

    # -- lookup ---------------------------------------------------------------

    def lookup(self, params, features: Dict[str, torch.Tensor],
               ctx: ParallelContext = LOCAL, *, method: str = "auto",
               fused: Optional[bool] = None,
               cache=None) -> Dict[str, torch.Tensor]:
        """features: name -> (B, max_valency) int32 ids, -1 padded (this
        rank's samples under a ranked context).

        Returns name -> (B, dim) combined embeddings.  ``method``: "auto",
        "a2a", "psum" or "local" (``ctx.emb_method`` overrides "auto");
        ``fused=None`` follows ``ctx.emb_pipeline``; ``cache`` is a
        ``HotIdCache`` (or its ``arrays()`` dict), consulted by the
        pipelined a2a path.  With no mesh, a model axis of one rank or
        ``method="local"``, every row space is read on this device (the
        reference's ``local_only`` branch), whatever the method.
        """
        if method == "auto" and ctx.emb_method != "auto":
            method = ctx.emb_method
        if method not in ("auto", "local", "psum", "a2a"):
            raise ValueError(f"unknown lookup method {method!r}")
        if fused is None:
            fused = ctx.emb_pipeline
        cache_arrays = (cache.arrays() if isinstance(cache, HotIdCache)
                        else (cache or {}))
        cache_scale = (cache.capacity_scale
                       if isinstance(cache, HotIdCache) else 1.0)
        ms = ctx.model_axis_size
        if ms <= 1 or not ctx.has_mesh or method == "local":
            if fused and (self.replicated or self.groups):
                return self._lookup_fused(params, features, which="all")
            out = self._lookup_replicated_legacy(params, features)
            for dim, g in sorted(self.groups.items()):
                ids_all, cols = self._concat_group_ids(g, features)
                rows = _gather_rows(params[g.name], ids_all)
                for name, a, b, combiner in cols:
                    out[name] = _combine(rows[:, a:b], ids_all[:, a:b],
                                         combiner)
            return out

        # locally resident tables: the fused single launch (or per table)
        if fused and self.replicated:
            out = self._lookup_fused(params, features, which="replicated")
        else:
            out = self._lookup_replicated_legacy(params, features)

        # sharded width-groups: the exchange mode per group, then each
        # mode's groups through one (pipelined) exchange
        psum_set: List[Tuple[Group, torch.Tensor, List]] = []
        a2a_set: List[Tuple[Group, torch.Tensor, List]] = []
        for dim, g in sorted(self.groups.items()):
            ids_all, cols = self._concat_group_ids(g, features)
            ids_all = ids_all.to(torch.int32)
            if method == "psum" or (method == "auto"
                                    and ids_all.shape[1] <= 4):
                psum_set.append((g, ids_all, cols))
            else:
                a2a_set.append((g, ids_all, cols))

        def unpack(sets, combined):
            for (g, ids, cols), comb in zip(sets, combined):
                out.update({name: comb[:, i]
                            for i, (name, a, b, c) in enumerate(cols)})

        if psum_set:
            unpack(psum_set, _rowsharded_psum(
                [params[g.name] for g, _, _ in psum_set],
                [i for _, i, _ in psum_set], ctx,
                cols_list=[c for _, _, c in psum_set], pipelined=fused))
        if a2a_set:
            tabs = [params[g.name] for g, _, _ in a2a_set]
            if fused:
                combined = _rowsharded_a2a_pipelined(
                    tabs, [i for _, i, _ in a2a_set], ctx,
                    cols_list=[c for _, _, c in a2a_set],
                    capacity_factor=ctx.emb_capacity_factor,
                    caches=[cache_arrays.get(g.name) for g, _, _ in a2a_set],
                    cache_scale=cache_scale)
            else:
                # one exchange a group in turn (the reference's per-group
                # path consults no cache)
                combined = [_rowsharded_a2a(
                    t, ids, ctx, cols=cols,
                    capacity_factor=ctx.emb_capacity_factor)
                    for t, (g, ids, cols) in zip(tabs, a2a_set)]
            unpack(a2a_set, combined)
        return out

    def _lookup_replicated_legacy(self, params, features
                                  ) -> Dict[str, torch.Tensor]:
        """Pre-v2 dataflow: one gather+combine per locally-resident table.
        Where a gradient is recorded, the tables of one row space share
        one ``ops.GatherRows`` (one gradient per row space, not one per
        table).  Otherwise each table is gathered and combined in turn, in
        ``replicated`` order (big tables first, widths interleaved): one
        table's (B, Vl, D) rows are alive at a time (a row space's at once
        is 13.4 GB for dlrm0's d256 tables at B = 4096), and the card's
        heavy tables overlap the host's launches for light ones."""
        units = self._units("replicated")
        if not (torch.is_grad_enabled()
                and any(params[key].requires_grad for _, key in units)):
            return {t.name: _combine(
                ops.embedding_gather(self.table_view(params, t),
                                     features[t.name].to(torch.int32)),
                features[t.name], t.combiner) for t in self.replicated}
        out: Dict[str, torch.Tensor] = {}
        for g, key in units:
            ids = [features[s.spec.name].to(torch.int32) for s in g.slots]
            spans = tuple((s.offset, s.rows) for s in g.slots)
            rows = ops.GatherRows.apply(params[key], spans, *ids)
            for s, r, i in zip(g.slots, rows, ids):
                out[s.spec.name] = _combine(r, i, s.spec.combiner)
        return out

    @staticmethod
    def _concat_group_ids(g: Group, features):
        """Concat a group's feature ids with row offsets; remember spans."""
        cols: List[Tuple[str, int, int, str]] = []
        parts = []
        c0 = 0
        for s in g.slots:
            ids = features[s.spec.name]
            parts.append(torch.where(ids >= 0, ids + s.offset, -1))
            cols.append((s.spec.name, c0, c0 + ids.shape[1], s.spec.combiner))
            c0 += ids.shape[1]
        return torch.cat(parts, dim=1), cols


class PipelinedEmbeddingExecutor:
    """EmbeddingCollection + hot-id cache + per-step LFU bookkeeping.

    The lookup stays stateless; this facade owns the host-side loop around
    it: observe the step's ids into the LFU, refresh the replicated hot
    rows every ``refresh_every`` steps, and hand the cache to the lookup.
    Under a ranked context ``observe`` gathers every rank's samples first
    (the global batch, in rank order), so every rank keeps the counts the
    reference keeps for the whole batch, and the same snapshot.
    """

    def __init__(self, coll: EmbeddingCollection, *,
                 cache: Optional[HotIdCache] = None,
                 refresh_every: int = 1, method: str = "auto"):
        self.coll = coll
        self.cache = cache
        self.refresh_every = max(1, refresh_every)
        self.method = method
        self._step = 0

    def observe(self, features, ctx: ParallelContext = LOCAL) -> None:
        """Fold one step's feature ids into the LFU counts (host-side).

        Only groups the engine routes through the a2a exchange are
        tracked: psum-routed (small-valency) groups never consult the
        cache, so counting them would skew hit_rate and waste snapshots.
        """
        if self.cache is None:
            return
        for dim, g in sorted(self.coll.groups.items()):
            vl = sum(features[s.spec.name].shape[1] for s in g.slots)
            if self.method in ("psum", "local") or (self.method == "auto"
                                                    and vl <= 4):
                continue
            ids, cols = self.coll._concat_group_ids(
                g, {s.spec.name: torch.as_tensor(features[s.spec.name])
                    for s in g.slots})
            if ctx.has_mesh:
                ids = ctx.all_gather(ids.to(torch.int32))
            ids = ids.cpu().numpy()
            for name, a, b, _ in cols:       # one table at a time
                self.cache.observe(g.name, ids[:, a:b])

    def step(self, params, features, ctx: ParallelContext = LOCAL) -> None:
        """Per-step bookkeeping: observe + periodic refresh."""
        self.observe(features, ctx)
        self._step += 1
        if self.cache is not None and self._step % self.refresh_every == 0:
            self.cache.refresh_all(self.coll, params, ctx)

    def lookup(self, params, features, ctx: ParallelContext = LOCAL
               ) -> Dict[str, torch.Tensor]:
        """The pipelined lookup with this executor's cache (see
        `EmbeddingCollection.lookup`; ``fused=True``)."""
        return self.coll.lookup(params, features, ctx, method=self.method,
                                fused=True, cache=self.cache)


# ---------------------------------------------------------------------------
# Local gather + combine
# ---------------------------------------------------------------------------


def _group_fused_lookup(arr, g: Group, features) -> Dict[str, torch.Tensor]:
    """The reference's XLA-shaped lookup over ONE width-group's (R, D) row
    space (``use_kernel=False``): one gather, then one masked reshape-sum
    per valency class.  The port's lookups go through the kernel or its
    plain version instead; the tests hold this against the reference."""
    slots = sorted(g.slots, key=lambda s: features[s.spec.name].shape[1])
    rows = torch.cat([torch.where(features[s.spec.name] >= 0,
                                  features[s.spec.name] + s.offset, -1)
                      for s in slots], dim=1)
    B = rows.shape[0]
    D = arr.shape[1]
    valid = rows >= 0
    vecs = arr[rows.long().clamp(0, arr.shape[0] - 1)]        # (B, S, D)
    out: Dict[str, torch.Tensor] = {}
    i = c0 = 0
    while i < len(slots):
        w = features[slots[i].spec.name].shape[1]
        j = i
        while j < len(slots) and features[slots[j].spec.name].shape[1] == w:
            j += 1
        cls = slots[i:j]
        nw = len(cls)
        a, b = c0, c0 + nw * w
        block = vecs[:, a:b].reshape(B, nw, w, D)
        vmask = valid[:, a:b].reshape(B, nw, w).to(vecs.dtype)
        seg = (block * vmask[..., None]).sum(dim=2)           # (B, nw, D)
        cnt = vmask.sum(dim=2)
        is_mean = torch.tensor([s.spec.combiner == "mean" for s in cls],
                               device=arr.device)
        denom = torch.where(is_mean[None, :], cnt.clamp_min(1.0),
                            torch.ones_like(cnt))
        seg = seg / denom[..., None]
        for k, s in enumerate(cls):
            out[s.spec.name] = seg[:, k]
        i, c0 = j, b
    return out


def _gather_rows(table, ids):
    """(V, D), (B, Vl) -> (B, Vl, D); invalid ids give zero rows.  The row
    gather kernel on the card, its plain version on the CPU; differentiable
    through ``ops.GatherRows``."""
    rows, = ops.GatherRows.apply(table, ((0, table.shape[0]),),
                                 ids.to(torch.int32))
    return rows


def _combine(rows, ids, combiner: str):
    """(B, Vl, D), (B, Vl) -> (B, D)."""
    valid = (ids >= 0).to(rows.dtype)
    out = (rows * valid[..., None]).sum(dim=1)
    if combiner == "mean":
        out = out / valid.sum(dim=1).clamp_min(1.0)[..., None]
    return out


# ---------------------------------------------------------------------------
# Distributed row-sharded lookups
# ---------------------------------------------------------------------------


def _segment_combine(rows, ids, cols):
    """(B, Vg, D) rows -> (B, K, D) per-table combined vectors (local op):
    one einsum with the columns' table-selection matrix, as the
    reference."""
    Vg = rows.shape[1]
    sel = torch.zeros((Vg, len(cols)), dtype=rows.dtype, device=rows.device)
    for i, (name, a, b, comb) in enumerate(cols):
        sel[a:b, i] = 1.0
    valid = (ids >= 0).to(rows.dtype)
    out = torch.einsum("bvd,vk->bkd", rows * valid[..., None], sel)
    counts = torch.einsum("bv,vk->bk", valid, sel)
    means = torch.tensor([c == "mean" for *_, c in cols], device=rows.device)
    denom = torch.where(means[None, :], counts.clamp_min(1.0),
                        torch.ones_like(counts))
    return out / denom[..., None]


def _owned_rows(table_loc, ids, ctx: ParallelContext):
    """The rows of ``ids`` (global row ids of the group, any shape (B, V))
    that this rank's shard holds, zero elsewhere: the row-gather kernel
    through ``ops.GatherRows`` on the shard's own row space."""
    rps = table_loc.shape[0]
    lid = ids - ctx.axis_index(ctx.model_axis) * rps
    ok = (ids >= 0) & (lid >= 0) & (lid < rps)
    rows, = ops.GatherRows.apply(table_loc, ((0, rps),),
                                 torch.where(ok, lid, -1).to(torch.int32))
    return rows


def _rowsharded_psum(tables, ids_list, ctx: ParallelContext, *, cols_list,
                     pipelined: bool):
    """The psum mode over the groups of ``tables`` (this rank's shards):
    stage A gathers the model axis's ids (the samples of this rank's data
    row, in model order), combines the rows this shard owns into
    (B_d, K, D) partials and starts their sum over the model axis; stage B
    waits and keeps this rank's samples.  ``pipelined`` issues group
    k+1's stage A before group k's stage B."""
    axis = ctx.model_axis
    m = ctx.axis_index(axis)

    def stage_a(k):
        ids = ctx.all_gather(ids_list[k], axis)
        part = _segment_combine(_owned_rows(tables[k], ids, ctx), ids,
                                cols_list[k])
        if ctx.emb_wire_bf16:
            part = part.to(torch.bfloat16)       # halve the reduction
        return part, ctx.all_reduce(part.detach(), axis, async_op=True)

    def stage_b(a, k):
        part, pending = a
        b = ids_list[k].shape[0]
        own = pending.then(lambda t: t[m * b:(m + 1) * b].clone())
        # transpose of (sum over the axis, keep own rows): every rank's
        # samples' gradients, gathered
        out = exchanged(part, own, lambda g: ctx.all_gather(g, axis))
        return out.float()

    if pipelined:
        return software_pipeline(stage_a, stage_b, range(len(tables)))
    return [stage_b(stage_a(k), k) for k in range(len(tables))]


@dataclass
class _Descriptors:
    """One group's id all-to-all payload and what the consume stage needs
    to reassemble per-occurrence vectors (the reference's tuple, with the
    send buffer packed: destination d's ids are the ``counts[d]`` <= C
    kept ones, in slot order)."""
    send: torch.Tensor      # (sum(counts),) int32 ids, grouped by destination
    counts: List[int]       # ids sent to each destination of the model axis
    slot: torch.Tensor      # (N,) int64 row of each unique id's vector
    keep: torch.Tensor      # (N,) bool: sent and within capacity
    inv: torch.Tensor       # (N,) int32 occurrence -> unique position
    hit: torch.Tensor       # (N,) bool: served by the cache
    cpos: torch.Tensor      # (N,) int64 position in the cache


def _a2a_descriptors(ids_loc, ms: int, rps: int, C: int, cache
                     ) -> _Descriptors:
    """Dedup one group's rank-local ids and lay out the send descriptors:
    uids sorted, so destinations are monotonic over the wanted ids, and an
    id's rank within its destination is the wanted ids before it less
    those before its destination's first.  Cache hits and ids ranked >= C
    are dropped (the reference's drop bucket) and never enter the
    exchange.  The reference sends C slots to every destination, padded
    with -1; the port sends each destination only its kept ids (the
    variable-length all-to-all of the paper's SparseCore): the same ids,
    dropped and kept alike, in fewer bytes."""
    N = ids_loc.numel()
    dev = ids_loc.device
    uids, inv, _ = dedup_ids(ids_loc.reshape(N))     # sorted, -1 tail
    valid_u = uids >= 0
    if cache is not None:
        cids, _ = cache
        cpos = torch.searchsorted(cids, uids).clamp(0, cids.shape[0] - 1)
        hit = valid_u & (cids[cpos] == uids)
    else:
        cpos = torch.zeros((N,), dtype=torch.int64, device=dev)
        hit = torch.zeros((N,), dtype=torch.bool, device=dev)
    want = valid_u & ~hit
    full_dest = torch.where(valid_u,
                            torch.div(uids, rps, rounding_mode="floor"), ms)
    dest = torch.where(want, full_dest, ms).long()   # ms = drop bucket
    wanted = want.long()
    cum = torch.cumsum(wanted, 0) - wanted           # exclusive prefix count
    cum_ext = torch.cat([cum, wanted.sum()[None]])
    starts = torch.searchsorted(
        full_dest, torch.arange(ms, dtype=full_dest.dtype, device=dev))
    before = cum_ext[starts]                         # wanted with dest < d
    rank = cum - before[dest.clamp(0, ms - 1)]
    keep = want & (rank < C)
    counts = torch.bincount(dest[keep], minlength=ms)
    offs = torch.cumsum(counts, 0) - counts
    total = int(counts.sum())
    slot = torch.where(keep, offs[dest.clamp(0, ms - 1)] + rank, total)
    send = torch.full((total + 1,), -1, dtype=torch.int32, device=dev)
    send[slot] = uids
    return _Descriptors(send[:-1], counts.tolist(), slot, keep, inv, hit,
                        cpos)


def _a2a_consume(table_loc, desc: _Descriptors, recv, got, ids_loc, cols,
                 ctx: ParallelContext, cache):
    """Owner-side gather + vector all-to-all + reassembly + combine ->
    (B, K, D).  ``recv``: the ids the ranks of the model axis asked this
    one for, ``got[j]`` of them from coordinate j."""
    axis = ctx.model_axis
    rows = _owned_rows(table_loc, recv[None, :], ctx)[0]   # (sum(got), D)
    if ctx.emb_wire_bf16:
        rows = rows.to(torch.bfloat16)   # halve the vector traffic
    there, back = (desc.counts, got), (got, desc.counts)
    vecs = exchanged(rows, ctx.all_to_all(rows.detach(), axis,
                                          async_op=True, splits=back),
                     lambda g: ctx.all_to_all(g, axis, splits=there)).float()
    D = vecs.shape[-1]
    vflat = torch.cat([vecs, vecs.new_zeros((1, D))])
    uvecs = vflat[desc.slot] * desc.keep[:, None].to(vflat.dtype)
    if cache is not None:
        hot = cache[1][desc.cpos].to(uvecs.dtype)     # replicated hot rows
        uvecs = torch.where(desc.hit[:, None], hot, uvecs)
    # broadcast to every occurrence and combine, in one fused lookup over
    # the received vectors: each table's valid columns summed in column
    # order (the one-device fused lookup's sum, so its bits where the
    # rows are the same), a mean table divided by its count; its backward
    # (the fused scatter) sums an id's occurrences in a fixed order
    occ = torch.where(ids_loc >= 0, desc.inv.reshape(ids_loc.shape),
                      -1).to(torch.int32)
    slots, col_slot = _combine_slots(cols, occ.device)
    return ops.FusedLookup.apply(occ, slots, col_slot, D, uvecs)


_SLOTS: Dict[Tuple, Tuple[torch.Tensor, torch.Tensor]] = {}


def _combine_slots(cols, device):
    """The fused lookup's slot table (K, 4) and column slots (S,) for a
    group's column spans ``cols``: one row space (0), each table's span
    [a, b) and mean flag (cached by layout and device)."""
    key = (tuple(cols), str(device))
    if key not in _SLOTS:
        # normal tensors even under inference_mode: a later backward saves
        with torch.inference_mode(False):
            _SLOTS[key] = (
                torch.tensor([(0, a, b, int(c == "mean"))
                              for _, a, b, c in cols], dtype=torch.int32,
                             device=device).reshape(-1, 4),
                torch.tensor([k for k, (_, a, b, _) in enumerate(cols)
                              for _ in range(a, b)], dtype=torch.int32,
                             device=device))
    return _SLOTS[key]


def _a2a_capacity(n_ids: int, ms: int, capacity_factor: float,
                  scale: float = 1.0) -> int:
    """Send slots a destination: ``n_ids`` the global batch's ids of the
    group (the reference's ``ids.shape[0] * ids.shape[1]``)."""
    return max(8, int(math.ceil(n_ids / ms * capacity_factor * scale)))


def _rowsharded_a2a(table, ids, ctx: ParallelContext, *, cols,
                    capacity_factor: float = 2.0):
    """The paper's SparseCore path for ONE width-group: dedup -> id
    all-to-all -> owner gather -> vector all-to-all -> per-occurrence
    broadcast -> local combine.  ids: (B, Vl), this rank's samples.
    Returns (B, K, D) combined vectors."""
    return _rowsharded_a2a_pipelined(
        [table], [ids], ctx, cols_list=[cols],
        capacity_factor=capacity_factor, caches=[None])[0]


def _rowsharded_a2a_pipelined(tables, ids_list, ctx: ParallelContext, *,
                              cols_list, capacity_factor: float = 2.0,
                              caches=None, cache_scale: float = 1.0):
    """All a2a-mode width-groups, double-buffered: group k+1's descriptor
    build and id all-to-all (started, not waited) are issued before group
    k's gather, vector all-to-all and combine (``software_pipeline``)."""
    axis = ctx.model_axis
    ms = ctx.model_axis_size
    n = len(tables)
    caches = list(caches) if caches is not None else [None] * n

    def make_run(with_cache: bool):
        # the cached forward provisions miss-only exchange buffers
        # (capacity * cache_scale); the uncached dataflow, also the exact
        # backward, keeps full capacity so no gradient is ever dropped
        caps = [_a2a_capacity(
            ids.numel() * ctx.batch_shards, ms, capacity_factor,
            cache_scale if (with_cache and caches[k] is not None) else 1.0)
            for k, ids in enumerate(ids_list)]

        def run(tabs):
            def stage_a(k):
                desc = _a2a_descriptors(
                    ids_list[k], ms, tabs[k].shape[0], caps[k],
                    caches[k] if with_cache else None)
                # how many ids each owner gets, then the ids themselves
                got = ctx.all_to_all(torch.tensor(
                    desc.counts, dtype=torch.int64,
                    device=desc.send.device)[:, None], axis)[:, 0].tolist()
                return desc, got, ctx.all_to_all(
                    desc.send, axis, async_op=True,
                    splits=(desc.counts, got))

            def stage_b(a, k):
                desc, got, pending = a
                return _a2a_consume(tabs[k], desc, pending.wait(), got,
                                    ids_list[k], cols_list[k], ctx,
                                    caches[k] if with_cache else None)

            return software_pipeline(stage_a, stage_b, range(n))
        return run

    run_plain = make_run(False)
    if all(c is None for c in caches):
        return run_plain(list(tables))
    return list(_CachedLookup.apply(make_run(True), run_plain, *tables))


class _CachedLookup(torch.autograd.Function):
    """Exact-gradient wrapper for the cached forward (the reference's
    ``_cached_vjp``): the forward serves hits from the (possibly stale)
    replicated snapshot; the backward differentiates the uncached
    dataflow at the same tables, so every gradient goes through the real
    id/vector all-to-alls to the sharded rows and none enters the
    snapshot."""

    @staticmethod
    def forward(ctx, run_cached, run_plain, *tables):
        ctx.run_plain = run_plain
        ctx.save_for_backward(*tables)
        return tuple(run_cached(list(tables)))

    @staticmethod
    def backward(ctx, *gouts):
        with torch.enable_grad():
            tabs = [t.detach().requires_grad_(True)
                    for t in ctx.saved_tensors]
            outs = ctx.run_plain(tabs)
            grads = torch.autograd.grad(outs, tabs, gouts)
        return (None, None, *grads)


# ---------------------------------------------------------------------------
# Reference (oracle for tests)
# ---------------------------------------------------------------------------


def materialize_tables(coll: EmbeddingCollection, params
                       ) -> Dict[str, torch.Tensor]:
    """Slice the grouped storage back into per-table (V, D) views."""
    out = {t.name: coll.table_view(params, t) for t in coll.replicated}
    for dim, g in sorted(coll.groups.items()):
        arr = params[g.name]
        for s in g.slots:
            out[s.spec.name] = arr[s.offset: s.offset + s.spec.vocab_size]
    return out


def lookup_reference(tables: Dict[str, torch.Tensor],
                     specs: Sequence[EmbeddingTableConfig],
                     features: Dict[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
    out = {}
    for t in specs:
        rows = _gather_rows(tables[t.name], features[t.name])
        out[t.name] = _combine(rows, features[t.name], t.combiner)
    return out
