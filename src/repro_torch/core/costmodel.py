"""Collective cost model over slice topologies (paper §2.6-2.8, §7.3).

Times are analytic lower-bound estimates from link-level routing:
  * all-reduce — multi-ring over every torus dimension (the standard
    torus reduction; wraparound doubles ring bandwidth, paper §2.6),
  * all-to-all — max-link-load under ideal multipath shortest-path routing
    (topology.link_loads_alltoall), the quantity the twisted torus improves,
  * all-gather / reduce-scatter — ring over the mapped dimensions,
  * p2p — neighbour hop (pipeline parallelism).

Hardware presets: TPU v4 (the paper's machine), TPU v5e (the roofline
runtime target per the grading spec), and a projected v5p-class point for
the heterogeneous-fleet model.

This module also owns the **Figure-12 per-app roofline model** (shared with
`benchmarks/fig12_v4_vs_v3.py`) and the **generation registry**: each
`Generation` tags a `HardwareParams` preset with its fig12-path performance
factor (geomean app speedup vs TPU v3) plus power/price economics, the
scoring inputs of the multi-machine fleet placer (`repro.cluster.registry`).
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

from repro_torch.core.topology import SliceTopology


@dataclass(frozen=True)
class HardwareParams:
    name: str
    peak_flops_bf16: float          # per chip
    hbm_bw: float                   # bytes/s per chip
    hbm_gib: float                  # per chip
    link_bw: float                  # bytes/s per direction per ICI link
    links_per_chip: int
    clock_hz: float
    sparsecores_per_chip: int = 4
    vmem_bytes: int = 2 * 16 * 2**20
    cmem_bytes: int = 128 * 2**20


TPU_V4 = HardwareParams(
    name="tpu_v4", peak_flops_bf16=275e12, hbm_bw=1200e9, hbm_gib=32,
    link_bw=50e9, links_per_chip=6, clock_hz=1.05e9, sparsecores_per_chip=4)

TPU_V3 = HardwareParams(
    name="tpu_v3", peak_flops_bf16=123e12, hbm_bw=900e9, hbm_gib=32,
    link_bw=70e9, links_per_chip=4, clock_hz=0.94e9, sparsecores_per_chip=2,
    cmem_bytes=0)

# Grading-spec constants: 197 TFLOP/s bf16, 819 GB/s HBM, ~50 GB/s/link.
TPU_V5E = HardwareParams(
    name="tpu_v5e", peak_flops_bf16=197e12, hbm_bw=819e9, hbm_gib=16,
    link_bw=50e9, links_per_chip=4, clock_hz=1.0e9, sparsecores_per_chip=4,
    cmem_bytes=0)

# Projected v5p-class point for the heterogeneous fleet (public v5p specs:
# 459 TFLOP/s bf16, 2765 GB/s HBM, 95 GiB/chip; CMEM dropped in favor of
# raw HBM bandwidth, so RNN1's CMEM outlier does not recur).
TPU_V5P = HardwareParams(
    name="tpu_v5p", peak_flops_bf16=459e12, hbm_bw=2765e9, hbm_gib=95,
    link_bw=100e9, links_per_chip=6, clock_hz=1.75e9,
    sparsecores_per_chip=4, cmem_bytes=0)


# ---------------------------------------------------------------------------
# Figure-12 per-app roofline model (shared with benchmarks/fig12_v4_vs_v3.py)
# ---------------------------------------------------------------------------

CMEM_BW_MULT = 3.0          # CMEM vs HBM effective bandwidth

# (name, operational intensity flops/byte, CMEM-resident fraction) for the
# paper's six production-app classes; RNN1's small weights/batch are
# CMEM-resident, producing the 3.3x outlier of Fig 12.
FIG12_APPS: Tuple[Tuple[str, float, float], ...] = (
    ("CNN0", 250.0, 0.1),
    ("CNN1", 150.0, 0.1),
    ("BERT0", 120.0, 0.15),
    ("BERT1", 100.0, 0.15),
    ("RNN0", 20.0, 0.3),
    ("RNN1", 12.0, 0.85),
)


def app_time_per_flop(hw: HardwareParams, oi: float, cmem_frac: float = 0.0,
                      *, cmem: bool = False) -> float:
    """Roofline seconds/flop for an app of operational intensity ``oi``:
    ``max(1/peak, 1/(oi * bw_eff))``, where CMEM (when present and enabled)
    raises the effective bandwidth for the ``cmem_frac`` of the working set
    it holds."""
    bw = hw.hbm_bw
    if cmem and hw.cmem_bytes > 0:
        bw = bw * (1.0 - cmem_frac) + bw * CMEM_BW_MULT * cmem_frac
    return max(1.0 / hw.peak_flops_bf16, 1.0 / (oi * bw))


def generation_speedup(hw: HardwareParams,
                       baseline: HardwareParams = TPU_V3) -> float:
    """Geomean speedup of ``hw`` over ``baseline`` across the Fig-12
    production-app mix (CMEM credited on whichever side has it).  This IS
    the measurement path of `benchmarks/fig12_v4_vs_v3.py`; the pinned
    `Generation.perf_factor` literals must round-trip through it (enforced
    by tests/test_hetfleet.py)."""
    logs = []
    for _name, oi, cf in FIG12_APPS:
        tb = app_time_per_flop(baseline, oi, cf, cmem=True)
        th = app_time_per_flop(hw, oi, cf, cmem=True)
        logs.append(math.log(tb / th))
    return math.exp(sum(logs) / len(logs))


# ---------------------------------------------------------------------------
# Generation registry: perf + economics per machine generation
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Generation:
    """One machine generation: hardware preset + fleet economics.

    ``perf_factor`` is the fig12-path geomean app speedup vs TPU v3
    (`generation_speedup`), pinned as a literal so drift in the shared
    roofline model is caught by the regression test.  ``watts_per_chip``
    follows the paper's §8 measured-power discussion (v4 at ~2.7x the
    perf/Watt of v3); ``dollars_per_chip_hour`` is a relative price point —
    old generations are cheap, which is exactly why batch/training work
    drains there while latency-SLO serving pays for fast silicon."""
    name: str
    hw: HardwareParams
    perf_factor: float              # fig12 geomean app speedup vs TPU_V3
    watts_per_chip: float
    dollars_per_chip_hour: float

    @property
    def perf_per_watt(self) -> float:
        """Relative app throughput per Watt (v3 = 1/283)."""
        return self.perf_factor / self.watts_per_chip

    @property
    def perf_per_dollar(self) -> float:
        """Relative app throughput per $/chip-hour — the training/batch
        placement score (old cheap silicon wins)."""
        return self.perf_factor / self.dollars_per_chip_hour

    def perf_per_watt_vs(self, other: "Generation") -> float:
        """Perf/Watt ratio vs another generation (v4 vs v3 ≈ 2.7x, §8)."""
        return self.perf_per_watt / other.perf_per_watt


# perf_factor literals are the measured generation_speedup() values (4dp);
# tests/test_hetfleet.py fails if either side drifts.
GEN_V3 = Generation("tpu_v3", TPU_V3, perf_factor=1.0,
                    watts_per_chip=283.0, dollars_per_chip_hour=0.55)
GEN_V4 = Generation("tpu_v4", TPU_V4, perf_factor=2.1193,
                    watts_per_chip=220.0, dollars_per_chip_hour=1.20)
GEN_V5P = Generation("tpu_v5p", TPU_V5P, perf_factor=3.2230,
                     watts_per_chip=350.0, dollars_per_chip_hour=2.20)

GENERATIONS: Dict[str, Generation] = {
    g.name: g for g in (GEN_V3, GEN_V4, GEN_V5P)}


@functools.lru_cache(maxsize=256)
def _a2a_max_load(dims: Tuple[int, int, int], twisted: bool,
                  wraparound: bool) -> float:
    topo = SliceTopology(dims, twisted=twisted, wraparound=wraparound)
    return topo.alltoall_max_load()


@functools.lru_cache(maxsize=256)
def _bisection(dims: Tuple[int, int, int], twisted: bool,
               wraparound: bool) -> int:
    topo = SliceTopology(dims, twisted=twisted, wraparound=wraparound)
    return topo.bisection_links()


class CollectiveCostModel:
    def __init__(self, hw: HardwareParams = TPU_V4):
        self.hw = hw

    # -- ring helpers ---------------------------------------------------------

    def _rings(self, topo: SliceTopology,
               dims_subset: Optional[Sequence[int]] = None) -> int:
        """Concurrent directed rings available over the given torus dims."""
        rings = 0
        for ax in range(3):
            size = topo.dims[ax]
            if dims_subset is not None and ax not in dims_subset:
                continue
            if size < 2:
                continue
            rings += 2 if (topo.wraparound and size > 2) else 1
        return max(rings, 1)

    def _group_size(self, topo: SliceTopology,
                    dims_subset: Optional[Sequence[int]]) -> int:
        if dims_subset is None:
            return topo.num_chips
        n = 1
        for ax in dims_subset:
            n *= topo.dims[ax]
        return n

    # -- collectives ----------------------------------------------------------

    def all_reduce(self, topo: SliceTopology, bytes_per_chip: float,
                   dims_subset: Optional[Sequence[int]] = None) -> float:
        """Ring all-reduce of `bytes_per_chip` over the mapped dims."""
        n = self._group_size(topo, dims_subset)
        if n <= 1:
            return 0.0
        rings = self._rings(topo, dims_subset)
        return 2.0 * bytes_per_chip * (n - 1) / n / (rings * self.hw.link_bw)

    def all_gather(self, topo: SliceTopology, bytes_per_chip_out: float,
                   dims_subset: Optional[Sequence[int]] = None) -> float:
        n = self._group_size(topo, dims_subset)
        if n <= 1:
            return 0.0
        rings = self._rings(topo, dims_subset)
        return bytes_per_chip_out * (n - 1) / n / (rings * self.hw.link_bw)

    reduce_scatter = all_gather

    def all_to_all(self, topo: SliceTopology,
                   bytes_per_chip: float) -> float:
        """Uniform all-to-all where each chip exchanges `bytes_per_chip`
        total with the N-1 others (the SparseCore / MoE pattern)."""
        n = topo.num_chips
        if n <= 1:
            return 0.0
        per_pair = bytes_per_chip / (n - 1)
        max_load = _a2a_max_load(topo.dims, topo.twisted, topo.wraparound)
        return max_load * per_pair / self.hw.link_bw

    def all_to_all_bisection_bound(self, topo: SliceTopology,
                                   bytes_per_chip: float) -> float:
        """Sanity bound: half the traffic crosses the bisection."""
        n = topo.num_chips
        cut = _bisection(topo.dims, topo.twisted, topo.wraparound)
        if cut == 0:
            return 0.0
        total = bytes_per_chip * n
        return (total / 2.0) / (2 * cut * self.hw.link_bw)

    def p2p(self, bytes_: float, hops: int = 1) -> float:
        return hops * bytes_ / self.hw.link_bw

    # -- reconfiguration --------------------------------------------------------

    def reconfig_time(self, circuits_moved: int,
                      arrays: Optional[int] = None) -> float:
        """Seconds of slice blackout to re-program ``circuits_moved`` OCS
        circuits (spare swap, straggler swap, re-twist): the ACOS-style
        per-switch-array model — arrays reconfigure in parallel, each
        serializes its own circuit programming, plus one MEMS settle.
        This is the price a repair decision trades against steady-state
        gain (a straggler swap only pays off if the recovered step time
        amortizes the blackout)."""
        from repro_torch.core.ocs import NUM_OCS, reconfig_time
        return reconfig_time(circuits_moved,
                             NUM_OCS if arrays is None else arrays)

    # -- compute / memory -------------------------------------------------------

    def compute_time(self, flops_per_chip: float,
                     efficiency: float = 1.0) -> float:
        return flops_per_chip / (self.hw.peak_flops_bf16 * efficiency)

    def hbm_time(self, bytes_per_chip: float) -> float:
        return bytes_per_chip / self.hw.hbm_bw
