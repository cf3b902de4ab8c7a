"""Dense layer pieces of the port: norms, RoPE, attention projections, MLP.

Ports of ``repro/models/layers.py`` with the same cast points:

  * norms compute in f32 and return the input dtype;
  * RoPE (NeoX half rotation) computes in f32 and casts back;
  * ``attention_qkv`` / ``attention_out`` / ``mlp_apply`` run bf16 matmuls
    on weights cast at use (``quant.cast``), bf16 out;
  * the SiLU-GLU product stays in bf16.

The prefill and decode attention are not here: they call the kernels
through ``kernels/ops.py`` (``models/transformer.py``).  `blocked_attention`
is the pooled suffix prefill's attention, plain torch as the reference's is
plain jnp (``transformer.prefill_suffix``).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import AttentionConfig, ModelConfig
from repro_torch.kernels.ref import NEG_INF
from repro_torch.models import quant as Q


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm(x, w, eps: float = 1e-6):
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + w.float())).to(dt)


def layernorm(x, w, b, eps: float = 1e-5):
    dt = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, unbiased=False)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * w.float() + b.float()).to(dt)


def nonparam_ln(x, eps: float = 1e-5):
    """OLMo's non-parametric LayerNorm (no scale, no bias)."""
    dt = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, unbiased=False)
    return ((x - mu) * torch.rsqrt(var + eps)).to(dt)


def apply_norm(cfg: ModelConfig, p, x):
    if cfg.norm == "nonparam_ln":
        return nonparam_ln(x)
    if cfg.norm == "layernorm":
        return layernorm(x, p["w"], p["b"])
    return rmsnorm(x, p["w"])


# ---------------------------------------------------------------------------
# RoPE (NeoX half-rotation convention)
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None):
    half = head_dim // 2
    return theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=device) / half)


def apply_rope(x, positions, theta: float):
    """x: (..., T, H, D); positions: broadcastable to (..., T)."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                       # (d/2,)
    angles = positions[..., None].float() * freqs                # (..., T, d/2)
    cos = torch.cos(angles)[..., None, :]                        # (..., T, 1, d/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention projections (GQA)
# ---------------------------------------------------------------------------

def attention_qkv(p, x, a: AttentionConfig, positions, *, rope: bool = True,
                  dtype=torch.bfloat16):
    """Project to q, k, v and apply RoPE.  x: (B, T, D) ->
    q (B, T, H, hd), k and v (B, T, KH, hd)."""
    q = torch.einsum("btd,dhk->bthk", x, Q.cast(p["wq"], dtype))
    k = torch.einsum("btd,dhk->bthk", x, Q.cast(p["wk"], dtype))
    v = torch.einsum("btd,dhk->bthk", x, Q.cast(p["wv"], dtype))
    if "bq" in p:
        q = q + p["bq"].to(dtype)
        k = k + p["bk"].to(dtype)
        v = v + p["bv"].to(dtype)
    if rope:
        q = apply_rope(q, positions, a.rope_theta)
        k = apply_rope(k, positions, a.rope_theta)
    return q, k, v


def attention_out(p, o, dtype=torch.bfloat16):
    """o (B, T, H, hd) -> (B, T, D)."""
    B, T, H, D = o.shape
    return torch.einsum("bthk,hkd->btd", o.to(dtype),
                        Q.cast(p["wo"], dtype).reshape(H, D, -1))


# ---------------------------------------------------------------------------
# Blocked online-softmax attention
# ---------------------------------------------------------------------------

def _mask_block(q_pos, kv_pos, window):
    """(B, Tq, Tk) causal allow-mask; a kv position of -1 is never
    allowed.  ``window``: None or tokens."""
    allow = (kv_pos[:, None, :] >= 0) & (kv_pos[:, None, :]
                                         <= q_pos[:, :, None])
    if window is not None:
        allow &= (q_pos[:, :, None] - kv_pos[:, None, :]) < window
    return allow


def blocked_attention(q, k, v, q_pos, kv_pos, *, window=None,
                      softcap: Optional[float] = None,
                      scale: Optional[float] = None, kv_chunk: int = 1024):
    """Causal online-softmax attention over KV chunks of ``kv_chunk`` lanes
    (the reference's ``blocked_attention``, same cast points).

    q (B, Tq, H, d); k, v (B, S, KH, d) (GQA: H % KH == 0); q_pos (B, Tq)
    and kv_pos (B, S) int logical positions, kv_pos -1 for a lane that
    holds nothing (it contributes exact zeros).  q * scale, k, the
    probabilities and v are rounded to bf16 and their products summed in
    f32 (bf16 products are exact in f32); scores, softmax and the running
    sums are f32.  Returns (B, Tq, H, d) in q's dtype.
    """
    B, Tq, H, D = q.shape
    S, KH = k.shape[1], k.shape[2]
    G = H // KH
    if scale is None:
        scale = D ** -0.5
    ck = min(kv_chunk, S)
    if S % ck:
        pad = ck - S % ck
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        kv_pos = F.pad(kv_pos, (0, pad), value=-1)
        S += pad
    bf = torch.bfloat16
    qr = (q.reshape(B, Tq, KH, G, D) * scale).to(bf).float()
    m = torch.full((B, Tq, KH, G), NEG_INF, device=q.device)
    l = torch.zeros((B, Tq, KH, G), device=q.device)
    acc = torch.zeros((B, Tq, KH, G, D), device=q.device)
    for c0 in range(0, S, ck):
        kb = k[:, c0:c0 + ck].to(bf).float()
        vb = v[:, c0:c0 + ck].to(bf).float()
        s = torch.einsum("btkgd,bckd->btkgc", qr, kb)
        if softcap is not None:
            s = softcap * torch.tanh(s / softcap)
        allow = _mask_block(q_pos, kv_pos[:, c0:c0 + ck],
                            window)[:, :, None, None, :]
        s = torch.where(allow, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None]) * allow
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "btkgc,bckd->btkgd", p.to(bf).float(), vb)
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.reshape(B, Tq, H, D).to(q.dtype)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def _act(name: str, x):
    if name == "gelu":
        return F.gelu(x, approximate="tanh")
    return F.silu(x)


def mlp_apply(cfg: ModelConfig, p, x, dtype=torch.bfloat16):
    if cfg.ffn_glu:
        g = torch.einsum("btd,df->btf", x, Q.cast(p["wg"], dtype))
        u = torch.einsum("btd,df->btf", x, Q.cast(p["wu"], dtype))
        h = _act(cfg.act, g) * u
    else:
        h = _act(cfg.act, torch.einsum("btd,df->btf", x,
                                       Q.cast(p["wi"], dtype)))
    return torch.einsum("btf,fd->btd", h, Q.cast(p["wo"], dtype))


# ---------------------------------------------------------------------------
# softcap
# ---------------------------------------------------------------------------

def softcap(x, cap: Optional[float]):
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)
