"""`repro_torch.embeddings` — the single-device SparseCore embedding engine
(``repro.embeddings``): placement plan, grouped storage, fused and
per-table lookups."""
from repro_torch.embeddings.engine import (EmbeddingCollection,
                                           lookup_reference,
                                           materialize_tables)
from repro_torch.embeddings.sharding import Placement, plan_placement

__all__ = ["EmbeddingCollection", "Placement", "lookup_reference",
           "materialize_tables", "plan_placement"]
