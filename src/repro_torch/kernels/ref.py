"""Plain PyTorch versions of the port's kernels.

Ports of ``repro/kernels/ref.py`` ``paged_decode_attention_ref``,
``paged_decode_attention_bt_ref``, ``flash_attention_ref``,
``embedding_gather_ref``, ``embedding_lookup_ref`` and
``embedding_scatter_ref`` (same arguments, same masking contract, f32
math; ``pool_rows`` is the block-table gather of the pooled one, which
``models/transformer.pool_view`` shares); the two decode versions also
take int8 K/V with ``k_scale``/``v_scale`` (one f32 scale a row and KV
head, ``models/quant.quantize_kv``) and dequantise in f32, as the Pallas
int8 bodies do: the plain versions of ``_decode_kernel_q`` and
``_decode_kernel_bt_q``.  ``fused_lookup_ref``,
``fused_lookup_q_ref`` and ``fused_scatter_ref`` are in the layout the
port's fused kernels take: the width-groups' row spaces where they lie,
not one padded copy of them.  ``ops`` sends CPU tensors here; the
CUDA kernels are held against these on the card (``chip_smoke.py``,
``tests/test_torch_cuda.py``) and these against JAX on the CPU
(``tests/test_torch_kernels_ref.py``, ``tests/test_torch_embeddings.py``,
``tests/test_torch_pooled.py``).
They are differentiable by autograd.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.fused_lookup import TILE

NEG_INF = -1e30


def dequant(q: torch.Tensor, scale: torch.Tensor, tile: int) -> torch.Tensor:
    """int8 ``q`` (..., D) times its tile's scale (..., ceil(D / tile)) in
    f32 (a partial last tile takes the last scale).  Each tile is scaled
    through a broadcast, so no per-lane copy of the scales is made."""
    D, nt = q.shape[-1], scale.shape[-1]
    if nt * tile != D:                          # pad the partial last tile
        q = F.pad(q, (0, nt * tile - D))
    r = q.unflatten(-1, (nt, tile)).float() * scale[..., None]
    return r.flatten(-2)[..., :D]


def dequant_rows(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """int8 rows ``q`` (..., D) times one scale a row (...), in f32."""
    return q.float() * scale[..., None]


def paged_decode_attention_ref(q, k, v, seq_lens, *,
                               k_scale=None, v_scale=None,
                               window: Optional[int] = None,
                               softcap: Optional[float] = None,
                               scale: Optional[float] = None):
    """q (B, H, d); k, v (B, S, KH, d); seq_lens (B,) int valid rows per slot
    (query attends kv_pos < seq_lens[b]; query position is seq_lens[b]-1)
    -> (B, H, d).  Slots with seq_len == 0 return zeros, as the kernel.
    int8 K/V: ``k_scale``, ``v_scale`` (B, S, KH) f32; each row becomes
    ``x * scale`` in f32 before the f32 math."""
    B, H, d = q.shape
    S, KH = k.shape[1], k.shape[2]
    G = H // KH
    if scale is None:
        scale = d ** -0.5
    if k_scale is not None:
        k, v = dequant_rows(k, k_scale), dequant_rows(v, v_scale)
    qr = q.reshape(B, KH, G, d).float() * scale
    s = torch.einsum("bkgd,bskd->bkgs", qr, k.float())
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    kpos = torch.arange(S, device=q.device)[None, :]         # (1, S)
    lens = seq_lens.to(torch.int64)[:, None]                 # (B, 1)
    allow = kpos < lens
    if window is not None:
        allow &= (lens - 1) - kpos < window
    allow_b = allow[:, None, None, :]                        # (B, 1, 1, S)
    s = torch.where(allow_b, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m) * allow_b
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bkgs,bskd->bkgd", p / l, v.float())
    return o.reshape(B, H, d).to(q.dtype)


def pool_rows(x: torch.Tensor, tables, dim: int = 0) -> torch.Tensor:
    """Each slot's logical view of the block pool ``x``, whose blocks and
    their rows are dims ``dim`` and ``dim + 1`` (NB, bs): blocks
    ``tables[b]`` (B, nb), clamped to [0, NB - 1], laid end to end, so
    those two dims become (B, nb * bs)."""
    NB, bs = x.shape[dim:dim + 2]
    B, nb = tables.shape
    t = tables.long().clamp(0, NB - 1).reshape(-1)
    return x.index_select(dim, t).reshape(*x.shape[:dim], B, nb * bs,
                                          *x.shape[dim + 2:])


def paged_decode_attention_bt_ref(q, k, v, seq_lens, tables, *,
                                  k_scale=None, v_scale=None,
                                  window: Optional[int] = None,
                                  softcap: Optional[float] = None,
                                  scale: Optional[float] = None):
    """q (B, H, d); k, v (NB, bs, KH, d) block pool; seq_lens (B,) int
    valid LOGICAL rows per slot; tables (B, nb) int logical -> pool block,
    clamped to [0, NB - 1] (an out-of-range entry's lanes lie past seq_len)
    -> (B, H, d).  Gathers each slot's logical view (B, nb * bs, KH, d) and
    its scales (int8: ``k_scale``, ``v_scale`` (NB, bs, KH) f32) and calls
    `paged_decode_attention_ref`."""
    def view(x):
        return None if x is None else pool_rows(x, tables)

    return paged_decode_attention_ref(
        q, view(k), view(v), seq_lens, k_scale=view(k_scale),
        v_scale=view(v_scale), window=window, softcap=softcap, scale=scale)


def flash_attention_ref(q, k, v, *, causal: bool = True,
                        window: Optional[int] = None,
                        softcap: Optional[float] = None,
                        scale: Optional[float] = None):
    """q (B, H, T, d); k, v (B, KH, S, d) -> (B, H, T, d)."""
    B, H, T, d = q.shape
    KH, S = k.shape[1], k.shape[2]
    G = H // KH
    if scale is None:
        scale = d ** -0.5
    qr = q.reshape(B, KH, G, T, d).float() * scale
    s = torch.einsum("bkgtd,bksd->bkgts", qr, k.float())
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    qpos = torch.arange(T, device=q.device)[:, None]
    kpos = torch.arange(S, device=q.device)[None, :]
    allow = torch.ones((T, S), dtype=torch.bool, device=q.device)
    if causal:
        allow &= kpos <= qpos
    if window is not None:
        allow &= (qpos - kpos) < window
    s = torch.where(allow, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgts,bksd->bkgtd", p, v.float())
    return o.reshape(B, H, T, d).to(q.dtype)


def embedding_gather_ref(table, ids):
    """table (V, D); ids (B, Vl) int, -1 = no value -> (B, Vl, D) rows,
    zeros for an id < 0; an id >= V reads row V - 1, as the kernel."""
    rows = table[ids.long().clamp(0, table.shape[0] - 1)]
    return torch.where((ids >= 0)[..., None], rows, 0.0)


def embedding_lookup_ref(table, ids, combiner: str = "sum"):
    """table (V, D); ids (B, Vl) int, -1 = no value -> (B, D) f32: each
    sample's valid rows summed, or for ``"mean"`` divided by their count
    floored at 1; an id >= V reads row V - 1, as the kernel."""
    if combiner not in ("sum", "mean"):
        raise ValueError(f"unknown combiner {combiner!r}")
    out = embedding_gather_ref(table, ids).float().sum(dim=1)
    if combiner == "mean":
        out = out / (ids >= 0).sum(dim=1, keepdim=True).clamp_min(1)
    return out


def embedding_scatter_ref(grads, ids, vocab: int):
    """grads (N, D); ids (N,) int -> (V, D) f32 zeros with the row of every
    id in [0, V) added into row id, in index order (``index_add_``:
    sequential on the CPU; on the card in order only under
    ``torch.use_deterministic_algorithms``).  An id < 0 adds nothing and
    an id >= V is dropped.  For unique ids this is the reference's
    ``embedding_scatter_ref`` (0 + each row, once)."""
    out = torch.zeros((vocab, grads.shape[1]), dtype=torch.float32,
                      device=grads.device)
    take = (ids >= 0) & (ids < vocab)
    out.index_add_(0, ids[take].long(), grads[take].float())
    return out


def fused_lookup_ref(groups: Sequence[torch.Tensor], rows, slots, dmax: int):
    """groups: G row spaces (R_g, D_g) f32; rows (B, S) int group-local row
    ids (-1 invalid); slots (K, 4) int: per output slot its group, the
    descriptor-column span [a, b) of ``rows`` and a mean flag
    -> (B, K, dmax) f32: per slot the sum (or the mean, count floored at
    1) of its valid rows, lanes >= D_g zero.

    Equals ``repro.kernels.ref.fused_lookup_ref`` over the groups padded
    to ``dmax`` lanes and concatenated, with absolute row ids."""
    B = rows.shape[0]
    out = []
    for g, a, b, mean in slots.tolist():
        table = groups[g]
        ids = rows[:, a:b]
        valid = ids >= 0
        vecs = embedding_gather_ref(table, ids).float()       # (B, w, D_g)
        acc = vecs.sum(dim=1)
        if mean:
            acc = acc / valid.sum(dim=1, keepdim=True).clamp_min(1)
        out.append(F.pad(acc, (0, dmax - table.shape[1])))
    if not out:
        return torch.zeros((B, 0, dmax), device=rows.device)
    return torch.stack(out, dim=1)


def fused_lookup_q_ref(qgroups: Sequence[torch.Tensor],
                       scales: Sequence[torch.Tensor], rows, slots,
                       dmax: int):
    """`fused_lookup_ref` over int8 row spaces: qgroups G (R_g, D_g) int8,
    scales G (R_g, ceil(D_g / TILE)) f32, TILE = 128 lanes (``models/quant.
    quantize_row_space``); every gathered row is dequantised (``q *
    scale`` of its tile, f32) before it is added -> (B, K, dmax) f32.
    Gathers rows slot by slot: no dequantised copy of a table is made.

    Equals ``repro.kernels.ops.fused_lookup_q`` over the quantised padded
    fused table (``quantize(fused_table, TILE)``), whose padding lanes
    are zero."""
    B = rows.shape[0]
    out = []
    for g, a, b, mean in slots.tolist():
        q, sc = qgroups[g], scales[g]
        ids = rows[:, a:b]
        valid = ids >= 0
        safe = ids.long().clamp(0, q.shape[0] - 1)
        vecs = torch.where(valid[..., None], dequant(q[safe], sc[safe], TILE),
                           0.0)                               # (B, w, D_g)
        acc = vecs.sum(dim=1)
        if mean:
            acc = acc / valid.sum(dim=1, keepdim=True).clamp_min(1)
        out.append(F.pad(acc, (0, dmax - q.shape[1])))
    if not out:
        return torch.zeros((B, 0, dmax), device=rows.device)
    return torch.stack(out, dim=1)


def column_slots(slots, S: int):
    """(K, 4) slot table -> (S,) int64: the slot whose span holds each
    descriptor column, -1 for a column no span holds (the reference's (S,)
    slot stream).  Spans are disjoint in every layout the engine builds;
    where two overlap, the higher slot index wins."""
    col = torch.full((S,), -1, dtype=torch.int64, device=slots.device)
    for k, (_, a, b, _) in enumerate(slots.tolist()):
        col[max(a, 0):max(min(b, S), 0)] = k
    return col


def fused_scatter_ref(gout, rows, slots, shapes: Sequence[Tuple[int, int]],
                      col_slot=None) -> List[torch.Tensor]:
    """Backward of `fused_lookup_ref`.  gout (B, K, dmax) f32 slot
    gradients, already scaled for mean slots; rows (B, S) int group-local
    row ids (-1 invalid); slots (K, 4) int (group, col a, col b, mean);
    shapes: (R_g, D_g) of each row space; col_slot: `column_slots` of
    ``slots`` (derived when not given) -> one (R_g, D_g) f32 gradient
    per row space: every valid descriptor (b, s) adds ``gout[b, k(s),
    :D_g]`` into its row, in (b, s) order (``index_add_``, sequential on
    the CPU).  An id at or past R_g is dropped, as JAX's scatter drops an
    out-of-bounds update.

    Equals ``repro.kernels.ref.fused_scatter_ref`` over the groups padded
    to ``dmax`` lanes and concatenated, sliced back into groups."""
    B, S = rows.shape
    col_slot = (column_slots(slots, S) if col_slot is None
                else col_slot.long())
    col_group = torch.where(col_slot >= 0,
                            slots[:, 0].long()[col_slot.clamp_min(0)], -1)
    b_idx = torch.arange(B, device=rows.device)[:, None].expand(B, S)
    out = []
    for g, (R, D) in enumerate(shapes):
        grad = torch.zeros((R, D), dtype=torch.float32, device=gout.device)
        take = (col_group == g)[None, :] & (rows >= 0) & (rows < R)
        src = gout[b_idx[take], col_slot.expand(B, S)[take], :D]
        grad.index_add_(0, rows[take].long(), src.float())
        out.append(grad)
    return out
