"""Plain PyTorch versions of the kernels on the serving path.

Ports of ``repro/kernels/ref.py`` ``paged_decode_attention_ref`` and
``flash_attention_ref``: same arguments, same masking contract, f32 math.
``ops`` sends CPU tensors here; the CUDA kernels are held against these
on the card (``chip_smoke.py``) and these against JAX on the CPU
(``tests/test_torch_kernels_ref.py``).
"""
from __future__ import annotations

from typing import Optional

import torch

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
