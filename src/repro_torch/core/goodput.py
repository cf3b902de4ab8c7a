"""Goodput vs CPU-host availability, with and without OCS (paper Figure 4).

Machine model: 4096 chips = 64 blocks (4×4×4 block grid); each block has 16
CPU hosts (4 chips/host); a block is schedulable only if all 16 hosts are up.

  * With OCS: a slice of k blocks can use ANY k healthy blocks — goodput is
    floor(healthy / k) * k / 64 in expectation (matches the Fig 4 caption
    arithmetic: at 99.0%-99.5% availability a 3K-chip slice gets 75%).
  * Without OCS (static cabling): slices must be CONTIGUOUS axis-aligned
    sub-grids of the fixed 4×4×4 block torus with every block healthy —
    availability must reach 99.9% before large slices schedule at all.

Alongside this *scheduled* goodput, `served_goodput` answers the fleet
question (repro.fleet): what fraction of offered serving traffic gets
delivered when each schedulable slice hosts a replica and failures re-route
load onto the survivors' headroom.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np

HOSTS_PER_BLOCK = 16
MACHINE_BLOCK_DIMS = (4, 4, 4)      # 64 blocks = 4096 chips
NUM_BLOCKS = 64


def block_alive_prob(host_availability: float) -> float:
    return host_availability ** HOSTS_PER_BLOCK


def _block_geometry(slice_blocks: int) -> Tuple[int, int, int]:
    """Most compact block-grid geometry that fits the machine."""
    best = None
    for a in range(1, 5):
        for b in range(a, 5):
            for c in range(b, 5):
                if a * b * c == slice_blocks:
                    cand = (a, b, c)
                    if best is None or sum(cand) < sum(best):
                        best = cand
    if best is None:
        raise ValueError(f"no contiguous geometry for {slice_blocks} blocks")
    return best


def _usable_fractions_ocs(slice_chips: int, host_availability: float, *,
                          trials: int, seed: int) -> np.ndarray:
    """Per-trial machine fraction schedulable as k-block slices (OCS)."""
    k = max(1, slice_chips // 64)
    p = block_alive_prob(host_availability)
    rng = np.random.default_rng(seed)
    healthy = rng.binomial(NUM_BLOCKS, p, size=trials)
    return (healthy // k) * k / NUM_BLOCKS


def _usable_fractions_static(slice_chips: int, host_availability: float, *,
                             trials: int, seed: int) -> np.ndarray:
    """Per-trial schedulable fraction under static cabling: slices must be
    contiguous axis-aligned healthy sub-grids (greedy packing, wrapping)."""
    k = max(1, slice_chips // 64)
    geom = _block_geometry(k)
    p = block_alive_prob(host_availability)
    rng = np.random.default_rng(seed)
    A, B, C = MACHINE_BLOCK_DIMS
    positions = list(itertools.product(range(A), range(B), range(C)))
    orients = set(itertools.permutations(geom))
    out = np.zeros(trials)
    for i in range(trials):
        alive = rng.random((A, B, C)) < p
        free = alive.copy()
        placed = 0
        for (ox, oy, oz) in positions:
            done = False
            for (ga, gb, gc) in orients:
                coords = [((ox + dx) % A, (oy + dy) % B, (oz + dz) % C)
                          for dx in range(ga) for dy in range(gb)
                          for dz in range(gc)]
                if all(free[c] for c in coords):
                    for c in coords:
                        free[c] = False
                    placed += 1
                    done = True
                    break
            if done and (placed + 1) * k > NUM_BLOCKS:
                break
        out[i] = placed * k / NUM_BLOCKS
    return out


def goodput_ocs(slice_chips: int, host_availability: float, *,
                trials: int = 2000, seed: int = 0) -> float:
    """Expected fraction of the machine doing useful work (OCS-connected)."""
    return float(_usable_fractions_ocs(
        slice_chips, host_availability, trials=trials, seed=seed).mean())


def goodput_static(slice_chips: int, host_availability: float, *,
                   trials: int = 2000, seed: int = 0) -> float:
    """Expected machine fraction when slices need contiguous healthy
    sub-grids of the fixed torus (greedy packing, axis-aligned, wrapping)."""
    return float(_usable_fractions_static(
        slice_chips, host_availability, trials=trials, seed=seed).mean())


def served_goodput(slice_chips: int, host_availability: float,
                   demand_fraction: float, *, mode: str = "ocs",
                   trials: int = 2000, seed: int = 0) -> float:
    """Fleet-level SERVED goodput: the expected fraction of *offered traffic*
    a serving fleet delivers, when every schedulable k-block slice hosts one
    replica and demand equals ``demand_fraction`` of the full machine's
    serving capacity.

    Scheduled goodput (`goodput_ocs`/`goodput_static`) asks "how much of the
    machine can do useful work"; served goodput asks the fleet question —
    "how much of what users ask for gets served".  They differ because
    demand below capacity hides failures (a lost replica's traffic re-routes
    to survivors with headroom, per §2.3 swap-a-spare + the fleet's
    failure-driven re-routing) until the healthy fleet saturates:

        served_i = min(usable_i, demand) / demand        per trial i

    At demand 1.0 this degenerates to scheduled goodput; at low demand the
    OCS fleet serves 100% through substantial block loss while static
    cabling starts shedding as soon as contiguity breaks."""
    assert 0.0 < demand_fraction <= 1.0, demand_fraction
    frac = {"ocs": _usable_fractions_ocs,
            "static": _usable_fractions_static}[mode]
    usable = frac(slice_chips, host_availability, trials=trials, seed=seed)
    return float(np.minimum(usable, demand_fraction).mean()
                 / demand_fraction)


def goodput_curve(availabilities: Sequence[float],
                  slice_sizes: Sequence[int], *,
                  trials: int = 1000) -> Dict[str, List[float]]:
    """Data for the Fig 4 plot: goodput per (availability, slice, ocs?)."""
    out: Dict[str, List[float]] = {"slice_chips": list(slice_sizes)}
    for av in availabilities:
        out[f"ocs_{av}"] = [goodput_ocs(s, av, trials=trials)
                            for s in slice_sizes]
        out[f"static_{av}"] = [goodput_static(s, av, trials=max(trials // 4, 100))
                               for s in slice_sizes]
    return out
