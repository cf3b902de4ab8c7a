"""Palomar-style Optical Circuit Switch fabric model (paper §2.1-2.2, §2.10).

The physical plant of one 4096-chip supercomputer:
  * 64 racks, each one 4×4×4 block (64 chips, 16 CPU hosts, electrical mesh
    inside),
  * 16 optical link-pairs per face dimension per block (6 faces × 16 links,
    circulators halve ports: 48 in/out pairs per block),
  * 48 OCSes of 136 ports (128 usable + 8 spares); pair k of every block
    lands on OCS k, so OCS k switches the dimension-k wraparound/inter-block
    links of the whole machine.

``OCSFabric.configure_slice`` programs the circuits for a block-level slice
(regular or twisted torus) and validates the 1:1 port constraint — this is
the software analogue of the "reprogramming of routing in the OCS" that makes
twisting free (§2.8).  ``reconfigure_around_failure`` swaps a spare block in
(§2.3) and reports how many circuits move (a millisecond-scale operation).
"""
from __future__ import annotations

import itertools
import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

BLOCK_EDGE = 4                  # chips per block edge (4^3 = 64 chips)
LINKS_PER_FACE = 16             # 4x4 chip faces
PAIRS_PER_BLOCK = 48            # 6 faces * 16 links / 2 (circulators)
OCS_PORTS = 136                 # 128 usable + 8 spares
OCS_USABLE_PORTS = 128
NUM_OCS = 48
SWITCH_TIME_S = 10e-3           # MEMS mirrors switch in milliseconds
# ACOS-style per-switch-array programming cost: each OCS serializes the
# re-programming of its own circuits (control-plane writes + mirror
# settling per circuit), while the 48 arrays work in parallel — so the
# reconfiguration tail grows with ceil(moved / arrays), not with the raw
# circuit count.  The MEMS switch time is paid once on top.
OCS_PROGRAM_S_PER_CIRCUIT = 1e-3


def reconfig_time(circuits_moved: int, arrays: int = NUM_OCS) -> float:
    """Seconds to re-program ``circuits_moved`` circuits across ``arrays``
    parallel switch arrays: one MEMS settle plus the per-array serialized
    programming of its share of the moves.  Zero moves cost zero — an
    identity reconfiguration never blacks the slice out."""
    if circuits_moved <= 0:
        return 0.0
    per_array = math.ceil(circuits_moved / max(1, arrays))
    return SWITCH_TIME_S + per_array * OCS_PROGRAM_S_PER_CIRCUIT


@dataclass(frozen=True)
class Circuit:
    """One OCS circuit: block A's '+' port pair k <-> block B's '-' pair k."""
    ocs: int
    dim: int
    pair: int                   # 0..15 within the face
    block_plus: int
    block_minus: int


@dataclass
class BlockSliceConfig:
    """A slice as a 3D grid of blocks with its torus circuits."""
    grid: Dict[Tuple[int, int, int], int]    # block-grid coord -> block id
    dims_blocks: Tuple[int, int, int]
    twisted: bool
    circuits: List[Circuit]


class OCSFabric:
    """Port accounting + circuit programming for one supercomputer."""

    def __init__(self, num_blocks: int = 64):
        self.num_blocks = num_blocks
        # ocs -> set of used (block, polarity) ports
        self._used: List[Dict[Tuple[int, str], Circuit]] = [
            dict() for _ in range(NUM_OCS)]

    # -- wiring rule ----------------------------------------------------------

    @staticmethod
    def ocs_for(dim: int, pair: int) -> int:
        """Pair (dim, i) of every block connects to the same OCS (§2.2)."""
        return dim * LINKS_PER_FACE + pair

    # -- circuit programming ----------------------------------------------------

    def configure_slice(self, blocks: Sequence[int],
                        dims_blocks: Tuple[int, int, int],
                        twisted: bool = False) -> BlockSliceConfig:
        """Program torus circuits for `blocks` arranged as dims_blocks.

        Blocks may come from anywhere in the machine (§2.5 scheduling
        benefit) — the OCS makes placement irrelevant.
        """
        a, b, c = dims_blocks
        assert a * b * c == len(blocks), (dims_blocks, len(blocks))
        grid = {}
        it = iter(blocks)
        for x, y, z in itertools.product(range(a), range(b), range(c)):
            grid[(x, y, z)] = next(it)

        dims = dims_blocks
        nshort = min(dims)
        tshort = dims.index(nshort)
        circuits: List[Circuit] = []
        for (x, y, z), blk in grid.items():
            coord = (x, y, z)
            for dim in range(3):
                size = dims[dim]
                if size == 1:
                    # self-wrap: the +/- faces of the same block connect
                    pass
                nxt = list(coord)
                nxt[dim] = (nxt[dim] + 1) % size
                wrapped = coord[dim] == size - 1
                if wrapped and twisted and dim == tshort:
                    for other in range(3):
                        if other != dim and dims[other] > nshort:
                            nxt[other] = (nxt[other] + nshort) % dims[other]
                nbr = grid[tuple(nxt)]
                for pair in range(LINKS_PER_FACE):
                    circuits.append(Circuit(
                        ocs=self.ocs_for(dim, pair), dim=dim, pair=pair,
                        block_plus=blk, block_minus=nbr))
        self._claim(circuits)
        return BlockSliceConfig(grid=grid, dims_blocks=dims_blocks,
                                twisted=twisted, circuits=circuits)

    def _claim(self, circuits: Sequence[Circuit]) -> None:
        for c in circuits:
            used = self._used[c.ocs]
            kp, km = (c.block_plus, "+"), (c.block_minus, "-")
            if kp in used or km in used:
                raise ValueError(
                    f"OCS {c.ocs} port conflict: {kp if kp in used else km}")
            if len(used) + 2 > 2 * OCS_USABLE_PORTS:
                raise ValueError(f"OCS {c.ocs} out of ports")
            used[kp] = c
            used[km] = c

    def release(self, cfg: BlockSliceConfig) -> None:
        for c in cfg.circuits:
            self._used[c.ocs].pop((c.block_plus, "+"), None)
            self._used[c.ocs].pop((c.block_minus, "-"), None)

    # -- failure handling ---------------------------------------------------------

    def reconfigure_around_failure(self, cfg: BlockSliceConfig,
                                   failed_block: int,
                                   spare_block: int) -> Tuple[int, float]:
        """Swap a failed block for a spare (§2.3: 'the OCS acts like a
        plugboard to skip failed units').  Returns (#circuits moved, seconds).
        """
        moved = 0
        self.release(cfg)
        for pos, blk in cfg.grid.items():
            if blk == failed_block:
                cfg.grid[pos] = spare_block
        new_circuits = []
        for c in cfg.circuits:
            bp = spare_block if c.block_plus == failed_block else c.block_plus
            bm = spare_block if c.block_minus == failed_block else c.block_minus
            if (bp, bm) != (c.block_plus, c.block_minus):
                moved += 1
            new_circuits.append(Circuit(c.ocs, c.dim, c.pair, bp, bm))
        cfg.circuits = new_circuits
        self._claim(new_circuits)
        # arrays reprogram in parallel; each serializes its own moves
        return moved, reconfig_time(moved)

    # -- twist-as-reconfiguration --------------------------------------------------

    def retwist(self, cfg: BlockSliceConfig, twisted: bool
                ) -> Tuple[BlockSliceConfig, int]:
        """Re-program the same blocks as a (un)twisted torus; returns the new
        config and the number of circuits that changed (§2.8: 'the only
        change is in the routing tables')."""
        old = {(c.ocs, c.block_plus): c.block_minus for c in cfg.circuits}
        self.release(cfg)
        blocks = [cfg.grid[k] for k in sorted(cfg.grid)]
        new = self.configure_slice(blocks, cfg.dims_blocks, twisted=twisted)
        changed = sum(
            1 for c in new.circuits
            if old.get((c.ocs, c.block_plus)) != c.block_minus)
        return new, changed


# ---------------------------------------------------------------------------
# Cost / power accounting (§2.10, §7.3)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class FabricCost:
    """Rough capital/power accounting used by benchmarks/fig_cost.py.

    Defaults are order-of-magnitude public numbers (chip cost includes the
    tray/host/rack share; transceivers at hyperscale volume pricing): the
    assertion target is the paper's <5% cost / <3% power claim and the IB
    comparison of §7.3.
    """
    chip_cost: float = 15_000.0          # per TPU incl. tray/host/rack share
    ocs_cost: float = 30_000.0           # per 136-port Palomar OCS
    transceiver_cost: float = 250.0      # per optical link end (volume)
    fiber_cost: float = 100.0            # per link
    chip_power_w: float = 170.0          # paper Table 4 mean
    ocs_power_w: float = 100.0           # holding MEMS mirrors
    transceiver_power_w: float = 2.5
    ib_switch_cost: float = 16_500.0     # Mellanox QM8790 (paper §7.3)
    ib_switch_power_w: float = 350.0
    ib_nic_cost: float = 1_000.0

    def ocs_fabric_cost(self, num_chips: int = 4096) -> Dict[str, float]:
        blocks = num_chips // 64
        links = blocks * PAIRS_PER_BLOCK          # optical link pairs
        cost = (NUM_OCS * self.ocs_cost
                + 2 * links * self.transceiver_cost
                + links * self.fiber_cost)
        power = (NUM_OCS * self.ocs_power_w
                 + 2 * links * self.transceiver_power_w)
        total_cost = cost + num_chips * self.chip_cost
        total_power = power + num_chips * self.chip_power_w
        return {
            "interconnect_cost": cost,
            "interconnect_power_w": power,
            "cost_fraction": cost / total_cost,
            "power_fraction": power / total_power,
        }

    def ib_fabric_cost(self, num_chips: int = 4096) -> Dict[str, float]:
        """3-level fat tree per Nvidia guidance (§7.3): 568 switches for 4096."""
        switches = round(num_chips * 568 / 4096)
        cost = switches * self.ib_switch_cost + num_chips * self.ib_nic_cost
        power = switches * self.ib_switch_power_w
        total_cost = cost + num_chips * self.chip_cost
        total_power = power + num_chips * self.chip_power_w
        return {
            "interconnect_cost": cost,
            "interconnect_power_w": power,
            "cost_fraction": cost / total_cost,
            "power_fraction": power / total_power,
        }
