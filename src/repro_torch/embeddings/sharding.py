"""Embedding-table placement planner (paper §3.3).

"There are three methods for partitioning: (1) column sharding splits tables
along their width, (2) row sharding splits tables along their vocabulary size,
and (3) table sharding places different tables on different chips.  For small
embedding tables, replication across all chips (using data parallelism) is
better for performance."

The planner assigns each table one of:
  * ``replicate``  — small tables, zero comm at lookup, all-reduce grads;
  * ``row``        — vocab split over the model axis, ids/vectors all-to-all;
  * ``table``      — whole table on one model shard (greedy size balancing),
                     results psum-merged;
  * ``column``     — width split over the model axis (kept for wide tables
                     feeding width-sharded dense layers).

A copy of ``repro.embeddings.sharding`` (the port imports nothing of the
JAX package).  On one shard every table is ``replicate``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Sequence

from repro_torch.configs.base import EmbeddingTableConfig

REPLICATE_BYTES = 4 << 20       # tables under 4 MiB replicate
TABLE_SHARD_BYTES = 256 << 20   # mid-size tables are whole-table placed


@dataclass(frozen=True)
class Placement:
    strategy: str               # replicate | row | table | column
    shard: int = 0              # owning shard (table strategy)
    padded_vocab: int = 0       # vocab padded to a multiple of the axis size


def plan_placement(tables: Sequence[EmbeddingTableConfig],
                   num_shards: int,
                   bytes_per_param: int = 4) -> Dict[str, Placement]:
    """Greedy plan matching the paper's guidance."""
    plan: Dict[str, Placement] = {}
    load = [0] * max(num_shards, 1)
    # big tables first so table-sharding balances well
    order = sorted(tables, key=lambda t: -t.vocab_size * t.dim)
    for t in order:
        size = t.vocab_size * t.dim * bytes_per_param
        if num_shards <= 1 or size <= REPLICATE_BYTES:
            plan[t.name] = Placement("replicate")
            continue
        if size <= TABLE_SHARD_BYTES:
            shard = min(range(num_shards), key=lambda i: load[i])
            load[shard] += size
            plan[t.name] = Placement("table", shard=shard)
            continue
        pad = (-t.vocab_size) % num_shards
        for i in range(num_shards):
            load[i] += size // num_shards
        plan[t.name] = Placement("row", padded_vocab=t.vocab_size + pad)
    return plan


def plan_summary(plan: Dict[str, Placement]) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for p in plan.values():
        out[p.strategy] = out.get(p.strategy, 0) + 1
    return out
