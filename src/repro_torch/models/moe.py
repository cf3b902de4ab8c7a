"""Mixture-of-Experts layer of the port, on one device.

The one-device half of ``repro/models/moe.py``: the router, the sorted
dropping dispatch (``moe_local``) and the one-device branches of
``moe_ep`` (prefill, capacity factor 1.25) and ``moe_decode`` (decode,
2.0).  Expert parallelism over several devices is ROADMAP.md queue 1,
item 12.  The expert products are plain batched matmuls (``torch.bmm``),
as the reference's are plain einsums outside any Pallas kernel.

Numerics kept from the reference, where they are easy to lose:
  * the router logits are a bf16 product cast to f32, so exact ties
    between experts are common; ``jax.lax.top_k`` takes the lower index
    first, and so does the stable descending sort here (``torch.topk``
    promises no order among equals);
  * the dispatch is a stable sort of the flattened (token, k) expert ids;
    an expert keeps its first ``capacity`` pairs in that order and drops
    the rest (a dropped pair adds exact zeros);
  * the combine adds each token's gated bf16 contributions one at a time,
    in ascending expert order, from bf16 zeros: the order of the
    reference's scatter-add over the expert-sorted pairs.  No atomics, so
    the card gives the same bits on every run;
  * mixed dtypes promote as JAX promotes them (an f32 input with bf16
    weights computes in f32).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.models import layers as L
from repro_torch.models import quant as Q
from repro_torch.parallel.context import LOCAL, ParallelContext


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------

def moe_init(cfg: ModelConfig, gen: torch.Generator, *,
             stacked: Optional[int] = None, device, dtype=torch.bfloat16):
    """The reference's ``moe_init`` layout and distributions (truncated
    normal over sqrt of each matrix's input width), from ``gen``."""
    m = cfg.moe
    d = cfg.d_model
    lead = () if stacked is None else (stacked,)

    def mk(*dims):
        return L.trunc_normal(gen, lead + dims, dims[-2], device, dtype)

    p = {"router": mk(d, m.num_experts),
         "wo": mk(m.num_experts, m.expert_ffw, d)}
    if cfg.ffn_glu:
        p["wg"] = mk(m.num_experts, d, m.expert_ffw)
        p["wu"] = mk(m.num_experts, d, m.expert_ffw)
    else:
        p["wi"] = mk(m.num_experts, d, m.expert_ffw)
    if m.num_shared_experts:
        f = m.shared_ffw * m.num_shared_experts
        p["shared"] = {"wg": mk(d, f), "wu": mk(d, f), "wo": mk(f, d)}
    return p


def _operands(x, w, dtype):
    """``x`` and the weight ``w`` cast to ``dtype``, both in the dtype JAX
    would promote the pair to."""
    w = Q.cast(w, dtype)
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt), w.to(dt)


def _mm(x, w, dtype):
    x, w = _operands(x, w, dtype)
    return torch.matmul(x, w)


# ---------------------------------------------------------------------------
# Router
# ---------------------------------------------------------------------------

def router_topk(cfg: ModelConfig, p, x, dtype=torch.bfloat16):
    """x: (S, D) -> gates (S, k) f32, expert idx (S, k), aux load-balance
    loss (Switch-style: E x sum of mean prob x top-1 fraction)."""
    m = cfg.moe
    logits = _mm(x, p["router"], dtype).float()
    if m.router_softcap:
        logits = m.router_softcap * torch.tanh(logits / m.router_softcap)
    probs = torch.softmax(logits, dim=-1)
    # top-k with ties to the lower index, as jax.lax.top_k
    srt = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, eidx = srt.values[:, :m.top_k], srt.indices[:, :m.top_k]
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    me = probs.mean(dim=0)                                    # (E,)
    ce = F.one_hot(eidx[:, 0], m.num_experts).float().mean(dim=0)
    aux = m.num_experts * torch.sum(me * ce)
    return gates, eidx, aux


def _shared_expert(cfg: ModelConfig, p, x, dtype=torch.bfloat16):
    g = _mm(x, p["wg"], dtype)
    u = _mm(x, p["wu"], dtype)
    return _mm(F.silu(g) * u, p["wo"], dtype)


def _expert_ffn(cfg: ModelConfig, p, buf, dtype=torch.bfloat16):
    """buf: (E, C, D) -> (E, C, D) with per-expert weights (E, D, F) and
    (E, F, D): one batched matmul per weight."""
    if cfg.ffn_glu:
        g = torch.bmm(*_operands(buf, p["wg"], dtype))
        u = torch.bmm(*_operands(buf, p["wu"], dtype))
        h = F.silu(g) * u
    else:
        h = F.silu(torch.bmm(*_operands(buf, p["wi"], dtype)))
    return torch.bmm(*_operands(h, p["wo"], dtype))


# ---------------------------------------------------------------------------
# Local sort-based dispatch
# ---------------------------------------------------------------------------

def _dispatch_sorted(x, gates, eidx, num_experts: int, capacity: int):
    """Sort-based dropping dispatch.

    x: (S, D); gates, eidx: (S, k).  Returns (buf (E, C, D), combine,
    dropped fraction): expert e's slot c holds the c-th (token, k) pair
    routed to e in the stable sort of the flattened ids (zeros past its
    count); ``combine(y)`` takes the expert outputs (E, C, D) back to (S,
    D).  Gathers only: every output element has one writer.
    """
    S, D = x.shape
    k = eidx.shape[1]
    dev = x.device
    E, C = num_experts, capacity
    flat_e = eidx.reshape(-1)                                  # (S*k,)
    order = torch.sort(flat_e, stable=True).indices
    sorted_e = flat_e[order]
    experts = torch.arange(E, device=dev, dtype=sorted_e.dtype)
    starts = torch.searchsorted(sorted_e, experts)             # (E,)
    counts = torch.searchsorted(sorted_e, experts, right=True) - starts
    pos = torch.arange(S * k, device=dev) - starts[sorted_e]   # in expert
    keep = pos < C
    # dispatch: slot (e, c) reads sorted pair starts[e] + c
    c = torch.arange(C, device=dev)
    filled = c[None, :] < counts[:, None]                      # (E, C)
    src = (starts[:, None] + c[None, :]).clamp(max=S * k - 1)
    rows = x[(order // k)[src]]                                # (E, C, D)
    buf = torch.where(filled[..., None], rows, torch.zeros((), dtype=x.dtype,
                                                            device=dev))
    # combine: token t's pairs in ascending expert order (its top-k ids
    # are distinct, so this is their order among the sorted pairs)
    e_tok, perm = torch.sort(eidx, dim=1)
    pos_flat = torch.empty_like(pos)
    pos_flat[order] = pos
    pos_tok = pos_flat.view(S, k).gather(1, perm)
    keep_tok = pos_tok < C
    slot = torch.where(keep_tok, e_tok * C + pos_tok, E * C)   # (S, k)
    gate_tok = gates.gather(1, perm)

    def combine(y):                                            # (E, C, D)
        y_flat = torch.cat([y.reshape(E * C, D),
                            torch.zeros((1, D), dtype=y.dtype, device=dev)])
        contrib = (y_flat[slot] * gate_tok[..., None].to(y.dtype)
                   * keep_tok[..., None].to(y.dtype))          # (S, k, D)
        out = torch.zeros((S, D), dtype=y.dtype, device=dev)
        for j in range(k):
            out = out + contrib[:, j]
        return out

    dropped = 1.0 - keep.float().mean()
    return buf, combine, dropped


def capacity_for(tokens: int, m: MoEConfig, factor: float) -> int:
    return max(4, int(math.ceil(tokens * m.top_k * factor / m.num_experts)))


def moe_local(cfg: ModelConfig, p, x, *, capacity_factor: float = 1.25,
              dtype=torch.bfloat16):
    """x: (S, D) -> (out (S, D), aux loss, dropped fraction)."""
    m = cfg.moe
    S = x.shape[0]
    gates, eidx, aux = router_topk(cfg, p, x, dtype)
    C = capacity_for(S, m, capacity_factor)
    buf, combine, dropped = _dispatch_sorted(x, gates, eidx, m.num_experts, C)
    out = combine(_expert_ffn(cfg, p, buf, dtype))
    if m.num_shared_experts:
        out = out + _shared_expert(cfg, p["shared"], x, dtype)
    return out, aux, dropped


# ---------------------------------------------------------------------------
# The reference's entry points, one device
# ---------------------------------------------------------------------------

def _one_device(ctx: ParallelContext, name: str) -> None:
    if ctx.has_mesh:
        raise NotImplementedError(
            f"{name} over several devices (expert parallelism) waits for "
            f"ROADMAP.md queue 1, item 12")


def _over_tokens(cfg, p, x, capacity_factor, dtype):
    B, T, D = x.shape
    out, aux, dropped = moe_local(cfg, p, x.reshape(B * T, D),
                                  capacity_factor=capacity_factor,
                                  dtype=dtype)
    return out.reshape(B, T, D), aux, dropped


def moe_ep(cfg: ModelConfig, p, x, ctx: ParallelContext = LOCAL, *,
           capacity_factor: float = 1.25, dtype=torch.bfloat16):
    """MoE over (B, T, D) activations (prefill, training): ``moe_local``
    over all B x T tokens at once, so capacity counts the whole batch."""
    _one_device(ctx, "moe_ep")
    return _over_tokens(cfg, p, x, capacity_factor, dtype)


def moe_decode(cfg: ModelConfig, p, x, ctx: ParallelContext = LOCAL, *,
               capacity_factor: float = 2.0, dtype=torch.bfloat16):
    """MoE over (B, 1, D) decode tokens: ``moe_local`` at the decode
    capacity factor."""
    _one_device(ctx, "moe_decode")
    return _over_tokens(cfg, p, x, capacity_factor, dtype)
