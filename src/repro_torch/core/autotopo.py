"""Topology × parallelism co-optimization search (paper §4, Table 3).

"We can also use search to tailor the TPU v4 topology to the DNN model."

Given a model's communication profile, enumerate
  slice geometry (4i×4j×4k)  ×  partition spec [pipeline, data, model1, model2]
  ×  activation/weight partitioning (1D/2D)
with each parallel degree mapped onto torus dimensions, and rank configs by a
step-time estimate built on the collective cost model.  Reproduces Table 3's
findings: for the 512-chip LLM the search moves a novice's 4×8×16 / 16×32
model-parallel config to the 8×8×8 cube, and for GPT-3 pre-training it
prefers deeper pipeline + data parallelism over the expert's 8×8 tensor grid.
"""
from __future__ import annotations

import itertools
import math
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from repro_torch.core.costmodel import CollectiveCostModel, HardwareParams, TPU_V4
from repro_torch.core.topology import SliceTopology, geometries_for, is_twistable


@dataclass(frozen=True)
class ModelProfile:
    """Communication-relevant summary of one training step (per replica)."""
    name: str
    params: float                    # trainable parameters
    layers: int
    d_model: int
    seq_len: int
    global_batch: int                # sequences
    bytes_per_param: int = 2         # bf16 weights/grads on the wire
    bytes_per_act: int = 2
    flops_per_token: Optional[float] = None   # default 6*params

    @property
    def tokens(self) -> float:
        return self.global_batch * self.seq_len

    @property
    def step_flops(self) -> float:
        per_tok = self.flops_per_token or 6.0 * self.params
        return per_tok * self.tokens


@dataclass(frozen=True)
class ParallelSpec:
    pipeline: int
    data: int
    model1: int
    model2: int
    act_partition: str = "2d"        # "1d" | "2d"
    weight_partition: str = "2d"

    @property
    def total(self) -> int:
        return self.pipeline * self.data * self.model1 * self.model2

    def label(self) -> str:
        return (f"[{self.pipeline},{self.data},{self.model1},{self.model2}] "
                f"{self.act_partition.upper()}/{self.weight_partition.upper()}")


@dataclass
class Evaluation:
    geometry: Tuple[int, int, int]
    spec: ParallelSpec
    step_time: float
    terms: Dict[str, float]

    @property
    def throughput(self) -> float:
        return 1.0 / self.step_time


# ---------------------------------------------------------------------------
# Step-time estimate
# ---------------------------------------------------------------------------

def _dim_assignments(dims: Tuple[int, int, int], spec: ParallelSpec
                     ) -> Optional[List[Dict[str, List[int]]]]:
    """Map each parallel degree onto whole torus dimensions (paper §2.7:
    'users map data parallelism along one dimension of the 3D torus and the
    two model parallel parameters on the other dimensions').

    Returns a list of axis->dims maps whose products match the spec, or None.
    """
    degrees = {"pipeline": spec.pipeline, "data": spec.data,
               "model1": spec.model1, "model2": spec.model2}
    out = []
    axes = [0, 1, 2]
    # assign each torus dim (possibly split) to a role greedily over perms
    for perm in itertools.permutations(axes):
        roles: Dict[str, List[int]] = {k: [] for k in degrees}
        sizes = dict(degrees)
        ok = True
        for ax in perm:
            d = dims[ax]
            placed = False
            for role in ("model1", "model2", "data", "pipeline"):
                if sizes[role] % d == 0 and sizes[role] >= d and d > 1:
                    roles[role].append(ax)
                    sizes[role] //= d
                    placed = True
                    break
            if not placed and d > 1:
                ok = False
                break
        if ok and all(v == 1 for v in sizes.values()):
            if not any(r == roles for r in out):
                out.append(roles)
    return out or None


def estimate_step_time(profile: ModelProfile,
                       dims: Tuple[int, int, int],
                       spec: ParallelSpec, *,
                       hw: HardwareParams = TPU_V4,
                       twisted: bool = False,
                       mfu: float = 0.55,
                       num_microbatches: Optional[int] = None
                       ) -> Optional[Evaluation]:
    """Analytic per-step time for one (geometry, partition spec) choice."""
    n = dims[0] * dims[1] * dims[2]
    if spec.total != n:
        return None
    assigns = _dim_assignments(dims, spec)
    if not assigns:
        return None
    topo = SliceTopology(dims, twisted=twisted)
    cm = CollectiveCostModel(hw)
    m = spec.model1 * spec.model2
    pp, dp = spec.pipeline, spec.data
    mb = num_microbatches or max(1, 2 * pp)

    best: Optional[Evaluation] = None
    for roles in assigns:
        # ---- compute
        flops_per_chip = profile.step_flops / n
        t_comp = flops_per_chip / (hw.peak_flops_bf16 * mfu)

        # ---- data-parallel gradient all-reduce (over the dp dims)
        grad_bytes = profile.params * profile.bytes_per_param / (m * pp)
        t_dp = cm.all_reduce(topo, grad_bytes, roles["data"] or None) \
            if dp > 1 else 0.0

        # ---- tensor-parallel activation collectives per layer
        layers_local = profile.layers / pp
        act_bytes = (profile.tokens / (dp * pp) * profile.d_model
                     * profile.bytes_per_act)
        t_tp = 0.0
        if m > 1:
            if spec.act_partition == "1d":
                # megatron-style: 2 all-reduces per layer fwd + 2 bwd over
                # the full model group
                mdl_dims = roles["model1"] + roles["model2"]
                t_tp = 4 * layers_local * cm.all_reduce(
                    topo, act_bytes / 1.0, mdl_dims or None)
            else:
                # 2D (GSPMD): all-gather over model1 + reduce-scatter over
                # model2, activations already split over the grid
                t_m1 = 4 * layers_local * cm.all_gather(
                    topo, act_bytes / max(spec.model2, 1),
                    roles["model1"] or None)
                t_m2 = 4 * layers_local * cm.reduce_scatter(
                    topo, act_bytes / max(spec.model1, 1),
                    roles["model2"] or None)
                t_tp = t_m1 + t_m2
            if spec.weight_partition == "2d" and dp > 1:
                # 2D weights add an all-gather of weight shards per layer
                w_bytes = (profile.params * profile.bytes_per_param
                           / (m * pp * dp))
                t_tp += cm.all_gather(topo, w_bytes, roles["data"] or None)

        # ---- pipeline p2p + bubble
        t_pp = 0.0
        bubble = 1.0
        if pp > 1:
            stage_act = (profile.tokens / (dp * mb) * profile.d_model
                         * profile.bytes_per_act)
            t_pp = 2.0 * mb * cm.p2p(stage_act)
            bubble = 1.0 + (pp - 1) / mb

        step = (t_comp + t_tp) * bubble + t_dp + t_pp
        ev = Evaluation(dims, spec, step,
                        {"compute": t_comp, "tp": t_tp, "dp": t_dp,
                         "pp": t_pp, "bubble": bubble})
        if best is None or ev.step_time < best.step_time:
            best = ev
    return best


# ---------------------------------------------------------------------------
# Search
# ---------------------------------------------------------------------------

def _factor_pairs(n: int) -> List[Tuple[int, int]]:
    out = []
    for a in range(1, n + 1):
        if n % a == 0:
            out.append((a, n // a))
    return out


def search(profile: ModelProfile, num_chips: int, *,
           hw: HardwareParams = TPU_V4,
           max_pipeline: int = 16,
           allow_twist: bool = True,
           top_k: int = 5,
           geometries: Optional[Sequence[Tuple[int, int, int]]] = None,
           twisted: Optional[bool] = None) -> List[Evaluation]:
    """Enumerate geometries × partition specs; return the top_k by step time.

    ``geometries`` restricts the search to the given slice shapes (the
    `Slice.dryrun` path: "what is the best partitioning on the slice I
    already hold?"); ``twisted`` forces the twist state instead of trying
    both where legal.
    """
    results: List[Evaluation] = []
    if geometries is None:
        geoms = geometries_for(num_chips)
    else:
        geoms = [tuple(g) for g in geometries
                 if g[0] * g[1] * g[2] == num_chips]
    for dims in geoms:
        if twisted is not None:
            if twisted and not is_twistable(dims):
                continue
            twists = [twisted]
        else:
            twists = [False]
            if allow_twist and is_twistable(dims):
                twists.append(True)
        for pp in [p for p in (1, 2, 4, 8, 16, 32) if p <= max_pipeline]:
            if num_chips % pp:
                continue
            rest = num_chips // pp
            for dp, mtot in _factor_pairs(rest):
                if profile.global_batch % (dp * pp):
                    continue
                for m1, m2 in _factor_pairs(mtot):
                    for ap, wp in (("1d", "1d"), ("1d", "2d"),
                                   ("2d", "2d")):
                        spec = ParallelSpec(pp, dp, m1, m2, ap, wp)
                        for tw in twists:
                            ev = estimate_step_time(
                                profile, dims, spec, hw=hw, twisted=tw)
                            if ev is not None:
                                results.append(ev)
    results.sort(key=lambda e: e.step_time)
    return results[:top_k]
