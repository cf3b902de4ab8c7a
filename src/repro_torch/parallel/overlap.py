"""Compute/communication overlap: the software pipeline of the SparseCore
embedding executor (port of ``repro/parallel/overlap.py``'s
``software_pipeline``).

Stage A of item k+1 is issued before stage B of item k.  In torch that
order is what overlaps: stage A ends by starting a collective with
``async_op=True`` (the embedding exchange's id all-to-all, or the psum
mode's all-reduce) and returns its pending handle; stage B waits on the
handle it is given.  So item k+1's exchange is in flight while item k's
gather and combine run.  Pure reordering: the results equal the
sequential loop's.  ``overlapped_matmul_ag`` / ``_rs`` are not ported.
"""
from __future__ import annotations

from typing import Callable, List, Sequence


def software_pipeline(stage_a: Callable, stage_b: Callable,
                      items: Sequence) -> List:
    """``[stage_b(stage_a(x), x) for x in items]``, with stage A of item
    k+1 issued before stage B of item k."""
    items = list(items)
    if not items:
        return []
    out = []
    buf = stage_a(items[0])
    for k, item in enumerate(items):
        nxt = stage_a(items[k + 1]) if k + 1 < len(items) else None
        out.append(stage_b(buf, item))
        buf = nxt
    return out
