"""Plain PyTorch versions of the port's kernels.

Ports of ``repro/kernels/ref.py`` ``paged_decode_attention_ref``,
``flash_attention_ref`` and ``embedding_gather_ref`` (same arguments, same
masking contract, f32 math), and ``fused_lookup_ref`` in the layout the
port's fused-lookup kernel takes: the width-groups' row spaces where they
lie, not one padded copy of them.  ``ops`` sends CPU tensors here; the
CUDA kernels are held against these on the card (``chip_smoke.py``,
``tests/test_torch_cuda.py``) and these against JAX on the CPU
(``tests/test_torch_kernels_ref.py``, ``tests/test_torch_embeddings.py``).
They are differentiable by autograd.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def paged_decode_attention_ref(q, k, v, seq_lens, *,
                               window: Optional[int] = None,
                               softcap: Optional[float] = None,
                               scale: Optional[float] = None):
    """q (B, H, d); k, v (B, S, KH, d); seq_lens (B,) int valid rows per slot
    (query attends kv_pos < seq_lens[b]; query position is seq_lens[b]-1)
    -> (B, H, d).  Slots with seq_len == 0 return zeros, as the kernel."""
    B, H, d = q.shape
    S, KH = k.shape[1], k.shape[2]
    G = H // KH
    if scale is None:
        scale = d ** -0.5
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
