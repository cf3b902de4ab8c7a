"""Dense layer pieces of the port: norms, RoPE, attention projections, MLP.

Ports of ``repro/models/layers.py`` with the same cast points:

  * norms compute in f32 and return the input dtype;
  * RoPE (NeoX half rotation) computes in f32 and casts back;
  * ``attention_qkv`` / ``attention_out`` / ``mlp_apply`` run bf16 matmuls
    on weights cast at use (``quant.cast``), bf16 out;
  * the SiLU-GLU product stays in bf16.

The serving prefill and decode attention are not here: they call the
kernels through ``kernels/ops.py`` (``models/transformer.py``).
`blocked_attention` (and `blocked_attention_qchunked`) is the training
forward's attention and the pooled suffix prefill's, plain torch as the
reference's is plain jnp: the reference has no kernel with a backward.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import AttentionConfig, ModelConfig
from repro_torch.kernels.ref import NEG_INF
from repro_torch.models import quant as Q


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

_LO, _HI = (0.5 * (1.0 + math.erf(z / math.sqrt(2.0))) for z in (-2.0, 2.0))
# elements drawn at once: a larger leaf is drawn in flat chunks, so its f32
# temporaries stay ~1 GB each (a full-width qwen3-moe expert leaf holds
# 9.7e9 elements)
INIT_CHUNK = 1 << 28


def _trunc_normal_flat(gen, shape, fan_in, device, dtype):
    u = torch.rand(shape, generator=gen, device=device)
    x = torch.erfinv(2.0 * (_LO + u * (_HI - _LO)) - 1.0) * math.sqrt(2.0)
    return (x.clamp_(-2.0, 2.0) / math.sqrt(fan_in)).to(dtype)


def trunc_normal(gen, shape, fan_in, device, dtype):
    """Normal truncated to [-2, 2], divided by sqrt(fan_in) (the reference's
    ``truncated_normal / sqrt(fan_in)``), by the inverse CDF, in ``dtype``.
    A leaf of more than `INIT_CHUNK` elements is drawn chunk by chunk
    straight into its ``dtype`` storage."""
    n = math.prod(shape)
    if n <= INIT_CHUNK or torch.device(device).type == "meta":
        return _trunc_normal_flat(gen, shape, fan_in, device, dtype)
    out = torch.empty(shape, device=device, dtype=dtype)
    flat = out.view(-1)
    for a in range(0, n, INIT_CHUNK):
        b = min(n, a + INIT_CHUNK)
        flat[a:b] = _trunc_normal_flat(gen, (b - a,), fan_in, device, dtype)
    return out


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

def _mask_block(q_pos, kv_pos, causal, window):
    """(B, Tq, Tk) allow-mask; a kv position of -1 is never allowed.
    ``window``: None or tokens."""
    allow = (kv_pos[:, None, :] >= 0).expand(-1, q_pos.shape[1], -1)
    if causal:
        allow = allow & (kv_pos[:, None, :] <= q_pos[:, :, None])
    if window is not None:
        allow = allow & ((q_pos[:, :, None] - kv_pos[:, None, :]) < window)
    return allow


def _online_softmax(qr, q_pos, k, v, kv_pos, starts, ck, *, causal, window,
                    softcap):
    """Online-softmax attention of ``qr`` (B, Tq, KH, G, D) f32 holding
    bf16 values over the KV chunks that begin at ``starts``, in that order.
    Returns the f32 (B, Tq, KH, G, D) output."""
    B, Tq, KH, G, D = qr.shape
    bf = torch.bfloat16
    m = torch.full((B, Tq, KH, G), NEG_INF, device=qr.device)
    l = torch.zeros((B, Tq, KH, G), device=qr.device)
    acc = torch.zeros((B, Tq, KH, G, D), device=qr.device)
    for c0 in starts:
        kb = k[:, c0:c0 + ck].to(bf).float()
        vb = v[:, c0:c0 + ck].to(bf).float()
        s = torch.einsum("btkgd,bckd->btkgc", qr, kb)
        if softcap is not None:
            s = softcap * torch.tanh(s / softcap)
        allow = _mask_block(q_pos, kv_pos[:, c0:c0 + ck], causal,
                            window)[:, :, None, None, :]
        s = torch.where(allow, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None]) * allow
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "btkgc,bckd->btkgd", p.to(bf).float(), vb)
        m = m_new
    return acc / l.clamp_min(1e-30)[..., None]


def blocked_attention(q, k, v, q_pos, kv_pos, *, causal: bool = True,
                      window=None, softcap: Optional[float] = None,
                      scale: Optional[float] = None, kv_chunk: int = 1024):
    """Online-softmax attention over KV chunks of ``kv_chunk`` lanes (the
    reference's ``blocked_attention``, same cast points; differentiable).

    q (B, Tq, H, d); k, v (B, S, KH, d) (GQA: H % KH == 0); q_pos (B, Tq)
    and kv_pos (B, S) int logical positions, kv_pos -1 for a lane that
    holds nothing (it contributes exact zeros).  q * scale, k, the
    probabilities and v are rounded to bf16 and their products summed in
    f32 (bf16 products are exact in f32); scores, softmax and the running
    sums are f32.  Returns (B, Tq, H, d) in q's dtype.
    """
    B, Tq, H, D = q.shape
    KH = k.shape[2]
    if scale is None:
        scale = D ** -0.5
    S = k.shape[1]
    ck = min(kv_chunk, S)
    if S % ck:                          # pad with masked lanes
        pad = ck - S % ck
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        kv_pos = F.pad(kv_pos, (0, pad), value=-1)
    qr = (q.reshape(B, Tq, KH, H // KH, D) * scale).to(torch.bfloat16).float()
    out = _online_softmax(qr, q_pos, k, v, kv_pos, range(0, k.shape[1], ck),
                          ck, causal=causal, window=window, softcap=softcap)
    return out.reshape(B, Tq, H, D).to(q.dtype)


def blocked_attention_qchunked(q, k, v, q_pos, kv_pos, *,
                               causal: bool = True,
                               window: Optional[int] = None,
                               softcap: Optional[float] = None,
                               scale: Optional[float] = None,
                               q_chunk: int = 2048, kv_chunk: int = 1024):
    """`blocked_attention` with q chunked too, over only the reachable
    (q-chunk, kv-chunk) pairs: causal masking skips the upper triangle and
    a static ``window`` (an int or None) keeps the diagonal band.  Each q
    chunk merges its kv chunks in ascending order, as the reference's scan
    over its i-major pair list does.  Assumes the aligned layout of
    training: q chunk i covers positions [i*cq, (i+1)*cq)."""
    B, Tq, H, D = q.shape
    S, KH = k.shape[1], k.shape[2]
    if scale is None:
        scale = D ** -0.5
    cq = min(q_chunk, Tq)
    ck = min(kv_chunk, S)
    assert Tq % cq == 0 and S % ck == 0, (Tq, cq, S, ck)
    qr = (q.reshape(B, Tq, KH, H // KH, D) * scale).to(torch.bfloat16).float()
    outs = []
    for i in range(Tq // cq):
        qlo, qhi = i * cq, (i + 1) * cq - 1
        starts = [j * ck for j in range(S // ck)
                  if not (causal and j * ck > qhi)
                  and not (window is not None
                           and qlo - ((j + 1) * ck - 1) >= window)]
        outs.append(_online_softmax(
            qr[:, qlo:qhi + 1], q_pos[:, qlo:qhi + 1], k, v, kv_pos, starts,
            ck, causal=causal, window=window, softcap=softcap))
    return torch.cat(outs, dim=1).reshape(B, Tq, H, D).to(q.dtype)


def reference_attention(q, k, v, q_pos, kv_pos, *, causal=True, window=None,
                        softcap=None, scale=None):
    """Unblocked oracle for tests (materialises the full logits, f32)."""
    B, Tq, H, D = q.shape
    KH = k.shape[2]
    if scale is None:
        scale = D ** -0.5
    qr = q.reshape(B, Tq, KH, H // KH, D).float() * scale
    s = torch.einsum("btkgd,bskd->btkgs", qr, k.float())
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    allow = _mask_block(q_pos, kv_pos, causal, window)[:, :, None, None, :]
    p = torch.softmax(torch.where(allow, s, NEG_INF), dim=-1)
    out = torch.einsum("btkgs,bskd->btkgd", p, v.float())
    return out.reshape(B, Tq, H, D).to(q.dtype)


def self_attention(p, x, a: AttentionConfig, positions, *,
                   causal: bool = True, window=None, kv_chunk: int = 1024,
                   dtype=torch.bfloat16):
    """Projections, `blocked_attention` and the output projection."""
    q, k, v = attention_qkv(p, x, a, positions, dtype=dtype)
    o = blocked_attention(q, k, v, positions, positions, causal=causal,
                          window=window, softcap=a.logit_softcap,
                          scale=a.attn_scale, kv_chunk=kv_chunk)
    return attention_out(p, o, dtype=dtype)


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
