"""Slice scheduler over OCS-connected 4³ blocks (paper §2.3, §2.5).

"For TPU v4, [the scheduler] can pick four 4³ blocks from anywhere in the
supercomputer.  Slices don't even need to be a power of 2."

Responsibilities:
  * allocate/free slices of any 4i×4j×4k geometry from ANY healthy free
    blocks (OCS mode) or from contiguous regions (static mode, for the Fig 4
    comparison),
  * block-failure handling: swap in a spare and reprogram circuits (§2.3),
  * straggler mitigation: the same swap mechanism replaces a slow block —
    an OCS capability (ms switch time) that static cabling cannot offer,
  * priorities + preemption support: every job carries a priority, and
    `preemption_victims` picks the cheapest set of lower-priority jobs whose
    blocks would let a higher-priority request fit — the mechanism behind
    "a serving burst evicts background training" (§2.3's availability story
    turned into scheduling policy).  The scheduler only *selects* victims;
    actually stopping them is cooperative and lives in the cluster layer
    (checkpoint, free, re-queue).
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.core.ocs import BlockSliceConfig, OCSFabric
from repro_torch.core.topology import SliceTopology, is_twistable

MACHINE_BLOCK_DIMS = (4, 4, 4)


def _shrink_reconfig_time(circuits_moved: int) -> float:
    """Blackout of reprogramming a shrunk slice's circuits (ACOS model)."""
    from repro_torch.core.ocs import reconfig_time
    return reconfig_time(circuits_moved)


@dataclass
class Job:
    """One placed slice: its chip geometry, owned blocks, OCS circuit
    configuration, and scheduling priority (higher preempts lower)."""
    job_id: int
    dims_chips: Tuple[int, int, int]
    twisted: bool
    blocks: List[int]
    config: BlockSliceConfig
    priority: int = 0

    @property
    def topology(self) -> SliceTopology:
        """Link-level topology for the job's geometry/twist."""
        return SliceTopology(self.dims_chips, twisted=self.twisted)


class SliceScheduler:
    """Block-level slice scheduler over one OCS machine.

    Args:
      num_blocks: machine size in 4^3-chip blocks.
      contiguous: static-cabling mode — slices must be contiguous regions
        and failures cannot be patched with spares (the Fig-4 baseline).
    """

    def __init__(self, num_blocks: int = 64, *, contiguous: bool = False):
        self.fabric = OCSFabric(num_blocks)
        self.num_blocks = num_blocks
        self.contiguous = contiguous       # static-cabling mode (no OCS)
        self.healthy: Set[int] = set(range(num_blocks))
        self.free: Set[int] = set(range(num_blocks))
        self.jobs: Dict[int, Job] = {}
        self.events: List[str] = []
        # block -> step-time multiplier (>= 1.0; absent = nominal).  A slow
        # block is healthy — it answers, it just drags every synchronous
        # step (§2.3's "stragglers" as distinct from failures) — so it
        # stays allocatable, but spare selection avoids it.
        self.slowdown: Dict[int, float] = {}
        self._next = 0

    # -- allocation -----------------------------------------------------------

    def allocate(self, dims_chips: Tuple[int, int, int], *,
                 twisted: bool = False, priority: int = 0) -> Optional[Job]:
        """Place a slice of ``dims_chips`` (each dim a multiple of 4) from
        any healthy free blocks.  Returns the `Job` or None if it cannot be
        placed at current capacity (see `preemption_victims` for what could
        be evicted to make room)."""
        a, b, c = dims_chips
        assert a % 4 == b % 4 == c % 4 == 0, "slices are built from 4^3 blocks"
        if twisted and not is_twistable(dims_chips):
            raise ValueError(f"{dims_chips} not twistable")
        dims_blocks = (a // 4, b // 4, c // 4)
        need = dims_blocks[0] * dims_blocks[1] * dims_blocks[2]
        avail = self.free & self.healthy
        if self.contiguous:
            blocks = self._find_contiguous(dims_blocks, avail)
        else:
            blocks = sorted(avail)[:need] if len(avail) >= need else None
        if blocks is None or len(blocks) < need:
            return None
        cfg = self.fabric.configure_slice(blocks, dims_blocks,
                                          twisted=twisted)
        job = Job(self._next, dims_chips, twisted, list(blocks), cfg,
                  priority=priority)
        self._next += 1
        self.free -= set(blocks)
        self.jobs[job.job_id] = job
        self.events.append(f"alloc job{job.job_id} {dims_chips} "
                           f"blocks={blocks} prio={priority}")
        return job

    def blocks_needed(self, dims_chips: Tuple[int, int, int]) -> int:
        """Block count of a chip geometry (each dim a multiple of 4)."""
        a, b, c = dims_chips
        return (a // 4) * (b // 4) * (c // 4)

    def preemption_victims(self, dims_chips: Tuple[int, int, int],
                           priority: int) -> Optional[List[Job]]:
        """Cheapest set of strictly-lower-priority jobs whose release would
        let a ``priority`` request for ``dims_chips`` fit.

        Victims are chosen lowest-priority-first, then fewest-blocks-first
        (evict as little work as possible), newest-first on ties.  Returns
        None when even evicting every lower-priority job would not free
        enough healthy blocks (OCS mode only — contiguous/static machines
        cannot re-carve around tenants, so preemption is not offered)."""
        if self.contiguous:
            return None
        need = self.blocks_needed(dims_chips)
        have = len(self.free & self.healthy)
        if have >= need:
            return []
        cands = sorted((j for j in self.jobs.values()
                        if j.priority < priority),
                       key=lambda j: (j.priority, len(j.blocks), -j.job_id))
        victims: List[Job] = []
        for j in cands:
            if have >= need:
                break
            victims.append(j)
            have += sum(1 for b in j.blocks if b in self.healthy)
        return victims if have >= need else None

    def _find_contiguous(self, dims_blocks, avail) -> Optional[List[int]]:
        A, B, C = MACHINE_BLOCK_DIMS

        def bid(x, y, z):
            return (x * B + y) * C + z

        for orient in set(itertools.permutations(dims_blocks)):
            ga, gb, gc = orient
            for ox, oy, oz in itertools.product(range(A), range(B), range(C)):
                ids = [bid((ox + dx) % A, (oy + dy) % B, (oz + dz) % C)
                       for dx in range(ga) for dy in range(gb)
                       for dz in range(gc)]
                if all(i in avail for i in ids):
                    return ids
        return None

    def release(self, job_id: int) -> None:
        """Free a job's blocks and OCS circuits back to the machine."""
        job = self.jobs.pop(job_id)
        self.fabric.release(job.config)
        self.free |= set(job.blocks)
        self.events.append(f"release job{job_id}")

    def shrink(self, job_id: int,
               new_dims: Tuple[int, int, int]) -> Tuple[List[int], int, float]:
        """Re-carve a job IN PLACE to the strictly-smaller ``new_dims``,
        handing the surplus blocks back to the free pool (§2.5 partial
        shrink: the tenant keeps running on fewer blocks instead of being
        fully evicted).  The job keeps its ``need`` fastest owned blocks
        (lowest slowdown, lowest id on ties) and the OCS circuits are
        reprogrammed to the smaller torus — one reconfiguration blackout,
        not a release + re-allocate.

        Returns ``(released_blocks, circuits_moved, switch_seconds)``.
        OCS mode only: a static-cabled machine cannot re-carve a contiguous
        region around a live tenant."""
        if self.contiguous:
            raise ValueError("shrink requires OCS wiring (contiguous mode "
                             "cannot re-carve around a live job)")
        job = self.jobs[job_id]
        a, b, c = new_dims
        assert a % 4 == b % 4 == c % 4 == 0, "slices are built from 4^3 blocks"
        need = self.blocks_needed(new_dims)
        assert 0 < need < len(job.blocks), \
            f"shrink must strictly reduce: {need} vs {len(job.blocks)} blocks"
        keep = sorted(job.blocks,
                      key=lambda blk: (self.slowdown_of(blk), blk))[:need]
        keep_set = set(keep)
        released = [blk for blk in job.blocks if blk not in keep_set]
        # a twist that the smaller geometry cannot express is dropped
        twisted = job.twisted and is_twistable(new_dims)
        self.fabric.release(job.config)
        dims_blocks = (a // 4, b // 4, c // 4)
        cfg = self.fabric.configure_slice(keep, dims_blocks, twisted=twisted)
        job.blocks = list(keep)
        job.dims_chips = (a, b, c)
        job.twisted = twisted
        job.config = cfg
        self.free |= set(released)
        moved = len(cfg.circuits)
        secs = _shrink_reconfig_time(moved)
        self.events.append(
            f"shrink job{job_id} -> {new_dims} released={released} "
            f"({moved} circuits, {secs * 1e3:.0f}ms)")
        return released, moved, secs

    # -- failures / stragglers ----------------------------------------------------

    def set_slowdown(self, block: int, factor: float) -> None:
        """Mark ``block`` as running ``factor``x slower than nominal (1.0
        clears the mark).  Pure telemetry state: sessions model their
        synchronous step time off it, the detector reads it back, and
        spare selection prefers fast blocks."""
        assert factor > 0.0, factor
        if factor <= 1.0:
            self.slowdown.pop(block, None)
        else:
            self.slowdown[block] = float(factor)
        self.events.append(f"slowdown block{block} x{factor:g}")

    def slowdown_of(self, block: int) -> float:
        """Current step-time multiplier of ``block`` (1.0 = nominal)."""
        return self.slowdown.get(block, 1.0)

    def _best_spare(self) -> Optional[int]:
        """Fastest healthy free block (ties to the lowest id — keeps the
        no-slowdown behavior identical to the historical sorted()[0])."""
        spares = self.free & self.healthy
        if not spares:
            return None
        return min(spares, key=lambda b: (self.slowdown_of(b), b))

    def fail_block(self, block: int) -> Optional[Tuple[int, int, float]]:
        """Mark a block failed.  If a job owned it, swap in a spare.

        Returns (job_id, circuits_moved, switch_seconds) or None.
        """
        self.healthy.discard(block)
        self.free.discard(block)
        owner = next((j for j in self.jobs.values() if block in j.blocks),
                     None)
        if owner is None:
            self.events.append(f"fail block{block} (idle)")
            return None
        if self.contiguous:
            # static cabling: the whole job dies and must wait for repair
            self.events.append(f"fail block{block}: job{owner.job_id} DOWN")
            self.release(owner.job_id)
            return (owner.job_id, 0, float("inf"))
        spare = self._best_spare()
        if spare is None:
            self.events.append(f"fail block{block}: no spares, "
                               f"job{owner.job_id} DOWN")
            self.release(owner.job_id)
            return (owner.job_id, 0, float("inf"))
        self.free.discard(spare)
        moved, secs = self.fabric.reconfigure_around_failure(
            owner.config, block, spare)
        owner.blocks[owner.blocks.index(block)] = spare
        self.events.append(
            f"fail block{block}: job{owner.job_id} re-routed to block{spare} "
            f"({moved} circuits, {secs * 1e3:.0f}ms)")
        return (owner.job_id, moved, secs)

    def repair_block(self, block: int) -> None:
        """Mark a failed block healthy again (free unless still mapped)."""
        self.healthy.add(block)
        if not any(block in j.blocks for j in self.jobs.values()):
            self.free.add(block)

    def swap_straggler(self, job_id: int, slow_block: int
                       ) -> Optional[Tuple[int, float]]:
        """Straggler mitigation: replace a slow (but healthy) block with
        the FASTEST spare.  Refuses (None) when no spare exists or every
        spare is at least as slow as the block being evicted — swapping
        sideways would pay the reconfiguration blackout for nothing."""
        job = self.jobs[job_id]
        spare = self._best_spare()
        if spare is None:
            self.events.append(
                f"straggler: job{job_id} block{slow_block} kept (no spare)")
            return None
        if (self.slowdown_of(slow_block) > 1.0
                and self.slowdown_of(spare) >= self.slowdown_of(slow_block)):
            self.events.append(
                f"straggler: job{job_id} block{slow_block} kept "
                f"(no faster spare)")
            return None
        self.free.discard(spare)
        moved, secs = self.fabric.reconfigure_around_failure(
            job.config, slow_block, spare)
        job.blocks[job.blocks.index(slow_block)] = spare
        self.free.add(slow_block)
        self.events.append(
            f"straggler: job{job_id} block{slow_block}->{spare}")
        return (moved, secs)

    # -- metrics ----------------------------------------------------------------

    def utilization(self) -> float:
        """Fraction of blocks owned by live jobs."""
        used = sum(len(j.blocks) for j in self.jobs.values())
        return used / self.num_blocks
