"""`MachineRegistry` — a fleet of `Supercomputer`s spanning generations.

The Jouppi et al. v2→Ironwood retrospective frames Google's ML real estate
as a *fleet of supercomputers across generations*, not one machine.  This
registry is that fleet: several `Supercomputer` instances (each its own OCS
fabric, scheduler, and failure domain) tagged with per-generation cost
models (`core.costmodel.Generation`), behind one placement surface:

    reg = MachineRegistry([
        Supercomputer(8, generation=GEN_V4),
        Supercomputer(8, generation=GEN_V3),
    ])
    sl = reg.allocate((4, 4, 4), objective="perf_watt", priority=1)

Placement ranks machines by a generation objective — ``perf`` (fastest
per-chip silicon: latency-SLO serving), ``perf_watt`` (the paper's §8
metric: v4 ≈ 2.7x v3), ``perf_dollar`` (cheap old silicon: batch/training
drains there), or ``blind`` (registration order; the baseline the het-fleet
benchmark must beat) — and walks the ranking twice: first taking genuinely
free capacity anywhere, then (when allowed) asking lower-priority tenants
to shrink or vacate.  A machine is never preempted while another still has
free blocks.

Job ids are per-machine; anything keying slices fleet-wide must key on
``(machine, job_id)`` — `slice_key` canonicalizes that.

Port of ``repro/cluster/registry.py`` over the port's `Supercomputer`s.
The machines of a registry may carry different generations and still
share one device: a generation prices a slice in virtual time, Watts and
dollars, while its compute runs where its machine's ``device`` says.
"""
from __future__ import annotations

from typing import (Any, Callable, Dict, Iterator, List, Optional, Sequence,
                    Tuple, Union)

from repro_torch.cluster.slices import Slice, SliceEvent
from repro_torch.cluster.supercomputer import CapacityError, Supercomputer

OBJECTIVES = ("perf", "perf_watt", "perf_dollar", "blind")


def slice_key(sl: Slice) -> Tuple[int, int]:
    """Fleet-wide identity of a slice: job ids are unique only within one
    machine, so cross-machine maps key on (machine identity, job id)."""
    return (id(sl._sc), sl.job_id)


class MachineRegistry:
    """An ordered collection of named `Supercomputer`s with generation-aware
    placement.  Iteration order is registration order."""

    def __init__(self, machines: Sequence[Supercomputer] = ()):
        self.machines: List[Supercomputer] = []
        self._by_name: Dict[str, Supercomputer] = {}
        for m in machines:
            self.add(m)

    # -- membership -----------------------------------------------------------

    def add(self, sc: Supercomputer,
            name: Optional[str] = None) -> Supercomputer:
        """Register a machine under ``name`` (default: its own name, which
        is usually the hardware preset's).  Collisions get a ``-2``/``-3``
        suffix so every machine is addressable."""
        base = name or sc.name
        unique, i = base, 2
        while unique in self._by_name:
            unique = f"{base}-{i}"
            i += 1
        sc.name = unique
        self._by_name[unique] = sc
        self.machines.append(sc)
        return sc

    def get(self, name: str) -> Supercomputer:
        return self._by_name[name]

    def names(self) -> List[str]:
        return [m.name for m in self.machines]

    def __iter__(self) -> Iterator[Supercomputer]:
        return iter(self.machines)

    def __len__(self) -> int:
        return len(self.machines)

    def __getitem__(self, i: int) -> Supercomputer:
        return self.machines[i]

    # -- events ---------------------------------------------------------------

    def subscribe(self, fn: Callable[[Slice, SliceEvent], None]):
        """Register a fleet-wide observer on every machine (see
        `Supercomputer.subscribe`).  Returns ``fn``."""
        for m in self.machines:
            m.subscribe(fn)
        return fn

    def unsubscribe(self, fn: Callable[[Slice, SliceEvent], None]) -> None:
        for m in self.machines:
            m.unsubscribe(fn)

    # -- scoring / ranking ----------------------------------------------------

    @staticmethod
    def score(sc: Supercomputer, objective: str) -> float:
        """Generation score of one machine under an objective (0.0 for
        ``blind`` or for machines outside the generation registry)."""
        g = sc.generation
        if objective == "blind" or g is None:
            return 0.0
        if objective == "perf":
            return g.perf_factor
        if objective == "perf_watt":
            return g.perf_per_watt
        if objective == "perf_dollar":
            return g.perf_per_dollar
        raise ValueError(f"objective {objective!r} not in {OBJECTIVES}")

    def rank(self, objective: str = "perf_watt") -> List[Supercomputer]:
        """Machines best-first under ``objective`` (registration order on
        ties — which makes ``blind`` exactly registration order)."""
        return sorted(self.machines,
                      key=lambda m: -self.score(m, objective))

    # -- placement ------------------------------------------------------------

    def allocate(self, geometry, *, objective: str = "perf_watt",
                 priority: int = 0, preempt: Union[bool, str] = False,
                 required: bool = False,
                 twisted: bool = False) -> Optional[Slice]:
        """Place a slice on the best machine under ``objective``.

        Two passes over the ranking: free capacity anywhere beats
        shrinking/evicting a tenant on a better machine, so preemption
        (``preempt=True`` or ``"shrink"``) is only attempted — best machine
        first — after every machine refused a clean allocation."""
        ranked = self.rank(objective)
        for m in ranked:
            sl = m.allocate(geometry, required=False, priority=priority,
                            twisted=twisted)
            if sl is not None:
                return sl
        if preempt:
            for m in ranked:
                sl = m.allocate(geometry, required=False, priority=priority,
                                preempt=preempt, twisted=twisted)
                if sl is not None:
                    return sl
        if required:
            raise CapacityError(
                f"no machine in {self.names()} can place {geometry}")
        return None

    # -- aggregate views ------------------------------------------------------

    def free_healthy_blocks(self) -> int:
        return sum(len(m.scheduler.free & m.scheduler.healthy)
                   for m in self.machines)

    @property
    def num_blocks(self) -> int:
        return sum(m.num_blocks for m in self.machines)

    def utilization(self) -> float:
        used = sum(m.utilization() * m.num_blocks for m in self.machines)
        return used / max(1, self.num_blocks)

    def overview(self) -> Dict[str, Any]:
        """Fleet snapshot: one `Supercomputer.overview` per machine plus
        the generation economics the placer scores with."""
        return {
            m.name: dict(
                m.overview(),
                generation=(m.generation.name if m.generation else None),
                perf_factor=(m.generation.perf_factor
                             if m.generation else None),
            )
            for m in self.machines
        }
