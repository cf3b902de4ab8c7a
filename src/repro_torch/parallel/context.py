"""ParallelContext of the port: what a single device needs.

The reference's ``repro/parallel/context.py`` binds axis names to a jax
mesh and imports JAX.  The port runs on one device, so its context has no
mesh and carries only what port code reads: ``has_mesh``.  The names are
the reference's (``Slice.parallel_context`` returns ``LOCAL``); several
devices, and the axis fields they need, are ROADMAP.md queue 1, item 12.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ParallelContext:
    @property
    def has_mesh(self) -> bool:
        return False


LOCAL = ParallelContext()
