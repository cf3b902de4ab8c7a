"""Dense layer pieces of the port: norms, RoPE, attention projections, MLP.

Ports of ``repro/models/layers.py`` with the same cast points:

  * norms compute in f32 and return the input dtype;
  * RoPE (NeoX half rotation) computes in f32 and casts back;
  * ``attention_qkv`` / ``attention_out`` / ``mlp_apply`` run bf16 matmuls
    on weights cast at use (``quant.cast``), bf16 out;
  * the SiLU-GLU product stays in bf16.

Attention itself is not here: prefill and decode call the kernels through
``kernels/ops.py`` (``models/transformer.py``).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import AttentionConfig, ModelConfig
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
