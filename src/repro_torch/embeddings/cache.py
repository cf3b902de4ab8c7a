"""Hot-id embedding cache — an LFU layer over deduplicated ids (§3.4-§3.5).

Port of ``repro/embeddings/cache.py``.  Production DLRM id streams are
Zipf-skewed: a small set of rows absorbs most lookups.  The SparseCore
dataflow still pays the id/vector all-to-all for every deduplicated id
each step; this cache keeps the hottest rows replicated on every rank so
their lookups skip the exchange (only misses ride the all-to-all, and
with ``capacity_scale`` < 1 its send buffers shrink to match).

  * ``observe`` — decayed per-group frequency counts over a step's ids
    (LFU with aging), on the host in numpy, as the reference;
  * ``refresh`` — snapshot the top-``capacity`` rows of a group into
    replicated ``(ids, rows)`` tensors, ids sorted ascending and padded
    with `SENTINEL` so a hit test is one ``searchsorted``;
  * ``entries`` / ``arrays`` — what the engine's lookup takes.

On a row-sharded group each rank holds rows [m * rps, (m + 1) * rps) only.
So ``refresh`` under a ranked context has each owner write the hot rows it
holds into zeros elsewhere, and sums the buffers over the model axis:
exactly one rank contributes each row, so the snapshot is exact and the
same on every rank.

Gradient contract (the reference's): the forward may serve slightly stale
rows, the backward is exact — the engine's cached lookup differentiates
the uncached dataflow, so every gradient reaches the sharded rows.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.parallel.context import LOCAL, ParallelContext

# sorts after every real row id; searchsorted never matches it
SENTINEL = np.int32(2 ** 31 - 1)


class HotIdCache:
    """Per-group LFU over deduplicated row ids."""

    def __init__(self, capacity: int = 64, *, decay: float = 0.9,
                 capacity_scale: float = 1.0):
        assert capacity >= 1
        self.capacity = capacity
        self.decay = decay
        # scales the all-to-all send capacity the engine provisions for the
        # cached forward; the caller owns provisioning: misses beyond the
        # shrunken capacity read back as zero vectors (the drop bucket), and
        # the backward always uses full capacity
        self.capacity_scale = capacity_scale
        self._counts: Dict[str, Dict[int, float]] = {}
        self._entries: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}
        self.hits = 0.0
        self.lookups = 0.0

    # -- statistics ----------------------------------------------------------

    def observe(self, group: str, ids) -> None:
        """Fold one step's (offset-adjusted) ids into the LFU counts.
        ``ids``: any int array or tensor; negatives are padding."""
        if isinstance(ids, torch.Tensor):
            ids = ids.cpu().numpy()
        flat = np.asarray(ids).reshape(-1)
        flat = flat[flat >= 0]
        if flat.size == 0:
            return
        counts = self._counts.setdefault(group, {})
        for k in list(counts):
            counts[k] *= self.decay
        uniq, freq = np.unique(flat, return_counts=True)
        for u, f in zip(uniq.tolist(), freq.tolist()):
            counts[u] = counts.get(u, 0.0) + float(f)
        if len(counts) > 8 * self.capacity:      # bound host memory
            keep = sorted(counts, key=counts.get, reverse=True)
            for k in keep[8 * self.capacity:]:
                del counts[k]
        # running hit-rate estimate against the current entry set
        ids_arr, _ = self._entries.get(group, (None, None))
        if ids_arr is not None:
            cached = ids_arr.cpu().numpy()
            self.hits += float(np.isin(flat, cached[cached != SENTINEL]).sum())
        self.lookups += float(flat.size)

    @property
    def hit_rate(self) -> float:
        return self.hits / max(self.lookups, 1.0)

    def hot_ids(self, group: str) -> np.ndarray:
        """The (capacity,) int32 ids the next refresh snapshots: the
        hottest, sorted ascending, `SENTINEL`-padded."""
        counts = self._counts.get(group, {})
        hot = sorted(counts, key=counts.get, reverse=True)[: self.capacity]
        ids = np.full((self.capacity,), SENTINEL, np.int32)
        ids[: len(hot)] = np.asarray(sorted(hot), np.int32)
        return ids

    # -- snapshot ------------------------------------------------------------

    @torch.no_grad()
    def refresh(self, group: str, table: torch.Tensor,
                ctx: ParallelContext = LOCAL, *,
                sharded: bool = False) -> None:
        """Snapshot the hottest rows of ``table``: the group's whole (R, D)
        row space, or with ``sharded`` this rank's rows of it (rank m of
        the model axis holds rows [m * rps, (m + 1) * rps))."""
        ids_np = self.hot_ids(group)
        ids = torch.from_numpy(ids_np).to(table.device)
        real = ids != int(SENTINEL)
        if sharded and ctx.model_axis_size > 1:
            rps = table.shape[0]
            lo = ctx.axis_index(ctx.model_axis) * rps
            mine = real & (ids >= lo) & (ids < lo + rps)
            rows = torch.zeros((ids.shape[0], table.shape[1]),
                               dtype=table.dtype, device=table.device)
            rows[mine] = table[(ids[mine] - lo).long()]
            rows = ctx.all_reduce(rows, ctx.model_axis)
        else:
            rows = table[ids.clamp_max(table.shape[0] - 1).long()]
            rows = torch.where(real[:, None], rows, torch.zeros_like(rows))
        self._entries[group] = (ids, rows)

    def refresh_all(self, coll, params, ctx: ParallelContext = LOCAL
                    ) -> None:
        """Refresh every *observed* width-group of an
        ``EmbeddingCollection`` (groups the executor never routes through
        the a2a exchange have no counts and get no snapshot)."""
        sharded = ctx.has_mesh and ctx.model_axis_size > 1
        for dim, g in sorted(coll.groups.items()):
            if g.name in self._counts:
                self.refresh(g.name, params[g.name], ctx, sharded=sharded)

    # -- device view ---------------------------------------------------------

    def entries(self, group: str
                ) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
        return self._entries.get(group)

    def arrays(self) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
        """group name -> (ids (C,) sorted int32 with sentinel pad, rows
        (C, D))."""
        return dict(self._entries)
