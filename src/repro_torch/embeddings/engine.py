"""Single-device embedding engine — the SparseCore lookup (§3.5) in PyTorch.

The single-device part of ``repro/embeddings/engine.py``: the grouped
table storage, the fused descriptor layout and the two lookup dataflows.

Storage
-------
Tables of the same width pack into one row space per width.  With
``fused_storage`` (the DLRM's layout) the locally resident tables live in
``local_d{D}`` row spaces; sharded width-groups (``num_shards > 1``) keep
their own ``group_d{D}`` row spaces.

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

Not ported yet (each raises ``NotImplementedError`` naming ROADMAP.md
queue 1, item 12, several devices): the distributed psum / all-to-all
exchanges and the hot-id cache with its ``PipelinedEmbeddingExecutor``,
which deduplicates ids on its way (``embeddings/dedup.py`` itself is
ported); the cache changes only the row-sharded all-to-all path, so on
one device it would be host bookkeeping only.
"""
from __future__ import annotations

import bisect
import itertools
from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import EmbeddingTableConfig
from repro_torch.embeddings.sharding import plan_placement
from repro_torch.kernels import ops

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


def _not_ported(what: str, item: int):
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP.md queue 1, "
        f"item {item})")


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

    def init(self, gen: torch.Generator,
             device=None) -> Dict[str, torch.Tensor]:
        """Every row space, N(0, 1) * 0.01 in f32 (the reference's
        distribution; other draws), on ``device`` (default: ``gen``'s).
        Each row space is drawn and scaled in place, so a large one never
        exists twice."""
        def draw(rows, dim):
            t = torch.empty((rows, dim), dtype=torch.float32,
                            device=gen.device if device is None else device)
            return t.normal_(generator=gen).mul_(0.01)

        params = {g.name: draw(g.total_rows, dim)
                  for dim, g in sorted(self.groups.items())}
        if self.fused_storage:
            params.update({g.name: draw(g.total_rows, dim)
                           for dim, g in sorted(self.local_groups.items())})
        else:
            params.update({t.name: draw(t.vocab_size, t.dim)
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

    def lookup(self, params, features: Dict[str, torch.Tensor], *,
               method: str = "auto", fused: bool = True,
               cache=None) -> Dict[str, torch.Tensor]:
        """features: name -> (B, max_valency) int32 ids, -1 padded.

        Returns name -> (B, dim) combined embeddings, computed on the one
        device that holds ``params`` (the reference's ``local_only``
        branch: every row space, sharded width-groups included, is read
        locally).  ``fused`` picks the one-launch descriptor lookup or the
        per-table gathers.
        """
        if method in ("psum", "a2a"):
            raise _not_ported(f"the distributed {method!r} lookup", 12)
        if method not in ("auto", "local"):
            raise ValueError(f"unknown lookup method {method!r}")
        if cache is not None:
            raise _not_ported("the hot-id cache (HotIdCache)", 12)
        if fused and (self.replicated or self.groups):
            return self._lookup_fused(params, features, which="all")
        out = self._lookup_replicated_legacy(params, features)
        for dim, g in sorted(self.groups.items()):
            ids_all, cols = self._concat_group_ids(g, features)
            rows = _gather_rows(params[g.name], ids_all)
            for name, a, b, combiner in cols:
                out[name] = _combine(rows[:, a:b], ids_all[:, a:b], combiner)
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
    """The reference's hot-id-cache executor facade: not ported yet."""

    def __init__(self, *args, **kwargs):
        raise _not_ported("PipelinedEmbeddingExecutor (hot-id cache, id "
                          "dedup)", 12)


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
