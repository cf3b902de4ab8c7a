"""Feature-id deduplication (paper §3.4): port of
``repro/embeddings/dedup.py``.

"To reduce load imbalance, deduplication of frequent feature values is
commonly used ... Deduplication also reduces the number of memory
accesses."  Sort-based and static-size, as the reference: the unique ids
padded with -1 to the input's length, plus the inverse map.  Its output
is the input contract of the embedding scatter
(``kernels/ops.embedding_scatter``): unique, sorted, a -1 tail.
"""
from __future__ import annotations

from typing import Tuple

import torch

_BIG = 2147483647        # padding sorts last


def dedup_ids(ids: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """ids (N,) int with -1 padding -> (unique (N,) int32 sorted, padded
    with -1 at the tail; inverse (N,) int32 with ``unique[inverse] ==
    ids`` at valid entries; num_unique () int32)."""
    n = ids.shape[0]
    clean = torch.where(ids < 0, _BIG, ids.to(torch.int32))
    uniq, inv = torch.unique(clean, sorted=True, return_inverse=True)
    out = torch.full((n,), _BIG, dtype=torch.int32, device=ids.device)
    out[:uniq.numel()] = uniq
    num = (out != _BIG).sum().to(torch.int32)
    return (torch.where(out == _BIG, -1, out), inv.to(torch.int32), num)


def dedup_ratio(ids: torch.Tensor) -> torch.Tensor:
    """Fraction of lookups saved by dedup (0 = all distinct)."""
    valid = (ids >= 0).sum()
    _, _, num = dedup_ids(ids)
    return 1.0 - num / valid.clamp_min(1)
