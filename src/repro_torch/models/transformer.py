"""Dense decoder stack of the port: init, prefill, paged decode, decode_n,
over a per-slot KV cache or a pooled block-table one (`init_kv_pool`,
`prefill_suffix`).

Ports of ``repro/models/transformer.py`` for the dense family.  JAX scans a
stacked layer body; here a Python loop walks the same stacked params
(``p["layers"][...][l]``).  JAX's arrays are immutable; the port writes the
KV cache IN PLACE (``cache_insert`` and ``decode_step_paged`` return the
cache they were given, updated), which saves a cache-sized copy per step.

Attention goes through ``kernels/ops.py``: the CUDA kernels on the card,
their plain versions on the CPU.  The JAX prefill computes attention with
``layers.blocked_attention`` (plain jnp); the port runs the flash kernel in
its place, so prefill logits agree with JAX within bf16 tolerance, not
bitwise.  The pooled suffix prefill (`prefill_suffix`) keeps the
reference's ``blocked_attention`` (plain torch, ``layers``): the flash
kernel has no query offset and no masked KV lanes.

Numerics kept from the reference, where they are easy to lose:
  * the residual stream is bf16 (``embed_tokens``);
  * ``unembed`` accumulates bf16 inputs in f32;
  * decode positions are the per-slot ``seq_lens``; a frozen slot (budget
    met) still writes a garbage KV row at ``min(seq_len, S-1)`` and keeps
    its length, and its emitted token repeats, so greedy outputs stay
    bitwise chunk-invariant.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as OPS
from repro_torch.kernels import ref as REF
from repro_torch.models import layers as L
from repro_torch.models import quant as Q

GLOBAL_WINDOW = 1 << 30


def _require_dense(cfg: ModelConfig) -> None:
    if cfg.family != "dense" or cfg.attention is None or cfg.vision_prefix:
        raise NotImplementedError(
            f"repro_torch serves the dense family only; {cfg.name} "
            f"({cfg.family}) waits for ROADMAP.md queue 1, item 11")


# ---------------------------------------------------------------------------
# per-layer window schedule
# ---------------------------------------------------------------------------

def window_schedule(cfg: ModelConfig) -> np.ndarray:
    """int32 (num_layers,): attention window per layer (GLOBAL_WINDOW = full)."""
    a = cfg.attention
    n = cfg.num_layers
    if a is None:
        return np.full((n,), GLOBAL_WINDOW, np.int32)
    if a.sliding_window is None or a.global_every == 0:
        return np.full((n,), GLOBAL_WINDOW, np.int32)
    win = np.full((n,), a.sliding_window, np.int32)
    for l in range(n):
        if l % a.global_every == a.global_every - 1:
            win[l] = GLOBAL_WINDOW
    return win


def _windows(cfg: ModelConfig):
    """Per-layer window as the kernels take it: None for a global layer."""
    return [None if w >= GLOBAL_WINDOW else int(w)
            for w in window_schedule(cfg)]


def _layer(tree, l: int):
    """Layer ``l`` of a stacked param tree (empty dicts stay empty; an int8
    `quant.QTensor` leaf gives layer ``l`` of its values and scales)."""
    if isinstance(tree, dict):
        return {k: _layer(v, l) for k, v in tree.items()}
    if isinstance(tree, Q.QTensor):
        return Q.QTensor(tree.q[l], tree.scale[l], tree.tile)
    return tree[l]


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

_LO, _HI = (0.5 * (1.0 + math.erf(z / math.sqrt(2.0))) for z in (-2.0, 2.0))


def _trunc_normal(gen, shape, fan_in, device, dtype):
    """Normal truncated to [-2, 2], divided by sqrt(fan_in) (the reference's
    ``truncated_normal / sqrt(dims[0])``), by the inverse CDF."""
    u = torch.rand(shape, generator=gen, device=device)
    x = torch.erfinv(2.0 * (_LO + u * (_HI - _LO)) - 1.0) * math.sqrt(2.0)
    return (x.clamp_(-2.0, 2.0) / math.sqrt(fan_in)).to(dtype)


def _norm_init(cfg: ModelConfig, L_: int, device, dtype):
    if cfg.norm == "nonparam_ln":
        return {}
    if cfg.norm == "layernorm":
        return {"w": torch.ones((L_, cfg.d_model), device=device, dtype=dtype),
                "b": torch.zeros((L_, cfg.d_model), device=device,
                                 dtype=dtype)}
    return {"w": torch.zeros((L_, cfg.d_model), device=device, dtype=dtype)}


def init_params(cfg: ModelConfig, gen: torch.Generator, *, device,
                dtype=torch.bfloat16) -> Dict[str, Any]:
    """Random params in the JAX layout (see ``interop``), from ``gen``.
    Same distributions as the reference's ``init_params``, not the same
    numbers: JAX's PRNG is not reproduced."""
    _require_dense(cfg)
    a = cfg.attention
    d, f, n = cfg.d_model, cfg.d_ff, cfg.num_layers
    H, KH, hd = a.num_heads, a.num_kv_heads, a.head_dim

    def tn(*shape):
        return _trunc_normal(gen, (n,) + shape, shape[0], device, dtype)

    attn = {"wq": tn(d, H, hd), "wk": tn(d, KH, hd), "wv": tn(d, KH, hd),
            "wo": tn(H * hd, d)}
    if a.qkv_bias:
        attn.update({k: torch.zeros((n, h, hd), device=device, dtype=dtype)
                     for k, h in (("bq", H), ("bk", KH), ("bv", KH))})
    mlp = {"wo": tn(f, d)}
    if cfg.ffn_glu:
        mlp.update(wg=tn(d, f), wu=tn(d, f))
    else:
        mlp["wi"] = tn(d, f)
    layers = {"ln1": _norm_init(cfg, n, device, dtype), "attn": attn,
              "ln2": _norm_init(cfg, n, device, dtype), "mlp": mlp}
    if cfg.post_norm:
        layers["post_ln1"] = _norm_init(cfg, n, device, dtype)
        layers["post_ln2"] = _norm_init(cfg, n, device, dtype)
    final = _norm_init(cfg, 1, device, dtype)
    p = {"embed": torch.randn((cfg.vocab_size, d), generator=gen,
                              device=device).to(dtype),
         "final_norm": {k: v[0] for k, v in final.items()},
         "layers": layers}
    if not cfg.tie_embeddings:
        p["head"] = _trunc_normal(gen, (d, cfg.vocab_size), d, device, dtype)
    return p


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

def embed_tokens(cfg: ModelConfig, p, tokens, dtype=torch.bfloat16):
    x = Q.take(p["embed"], tokens, dtype)
    if cfg.embed_scale:
        x = x * torch.tensor(np.sqrt(cfg.d_model), dtype=dtype)
    return x


def unembed(cfg: ModelConfig, p, x, dtype=torch.bfloat16):
    """(B, T, D) -> f32 logits (B, T, V).  Inputs are rounded to bf16 and the
    products summed in f32 (the reference's ``preferred_element_type``)."""
    w = (Q.cast(p["embed"], dtype).T if cfg.tie_embeddings
         else Q.cast(p["head"], dtype))
    logits = torch.matmul(x.to(dtype).float(), w.float())
    return L.softcap(logits, cfg.final_logit_softcap)


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Cache:
    k: torch.Tensor                      # (L, B, S, KH, hd)
    v: torch.Tensor
    pos: torch.Tensor                    # () int32: tokens already cached


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, device,
               dtype=torch.bfloat16) -> Cache:
    _require_dense(cfg)
    a = cfg.attention
    kv = (cfg.num_layers, batch, max_len, a.num_kv_heads, a.head_dim)
    return Cache(k=torch.zeros(kv, dtype=dtype, device=device),
                 v=torch.zeros(kv, dtype=dtype, device=device),
                 pos=torch.zeros((), dtype=torch.int32, device=device))


def init_kv_pool(cfg: ModelConfig, num_blocks: int, block_size: int, *,
                 device) -> Cache:
    """Pooled KV cache: k, v (L, NB, bs, KH, hd) bf16 zeros, indexed by
    per-slot block tables (logical block j of slot b is pool block
    ``tables[b, j]``).  Dense attention families only, as the reference asserts."""
    _require_dense(cfg)
    a = cfg.attention
    kv = (cfg.num_layers, num_blocks, block_size, a.num_kv_heads, a.head_dim)
    return Cache(k=torch.zeros(kv, dtype=torch.bfloat16, device=device),
                 v=torch.zeros(kv, dtype=torch.bfloat16, device=device),
                 pos=torch.zeros((), dtype=torch.int32, device=device))


def _pool_writes(dest, n_rows: int):
    """Rows to write for flat pool rows ``dest`` (N,), dropping any outside
    [0, n_rows) as JAX's scatter does, with no host sync: lane i writes the
    new row of lane ``src[i]`` at pool row ``at[i]``.  A dropped lane takes
    the source and target of the first kept lane, so targets that repeat
    carry equal rows and the order of the writes does not matter; when no
    lane is kept (``any_kept`` false) every lane rewrites what ``at[i]``
    holds.  Returns (src, at, any_kept)."""
    keep = (dest >= 0) & (dest < n_rows)
    first = keep.to(torch.int32).argmax()       # 0 when none is kept
    lanes = torch.arange(dest.shape[0], device=dest.device)
    src = torch.where(keep, lanes, first)
    return src, dest[src].clamp(0, n_rows - 1), keep.any()


def _write_rows(flat, src, at, any_kept, new):
    """``flat`` (..., R, KH, hd) pool rows, in place: row ``at[i]`` takes
    ``new[..., src[i], :, :]`` (see `_pool_writes`)."""
    flat[..., at, :, :] = torch.where(any_kept,
                                      new[..., src, :, :].to(flat.dtype),
                                      flat[..., at, :, :])


# ---------------------------------------------------------------------------
# Layer body
# ---------------------------------------------------------------------------

def _layer_tail(cfg: ModelConfig, lp, x, h):
    """Residual add of the attention output ``h``, then the MLP block."""
    if cfg.post_norm:
        h = L.apply_norm(cfg, lp["post_ln1"], h)
    x = x + h
    h = L.mlp_apply(cfg, lp["mlp"], L.apply_norm(cfg, lp["ln2"], x))
    if cfg.post_norm:
        h = L.apply_norm(cfg, lp["post_ln2"], h)
    return x + h


# ---------------------------------------------------------------------------
# Prefill
# ---------------------------------------------------------------------------

def prefill(cfg: ModelConfig, p, batch: Dict[str, Any], *,
            max_len: Optional[int] = None) -> Tuple[torch.Tensor, Cache]:
    """Forward over the prompt; returns (last-position logits (B, V) f32,
    filled cache of length ``max_len`` (default T))."""
    _require_dense(cfg)
    tokens = batch["tokens"]
    B, T = tokens.shape
    a = cfg.attention
    x = embed_tokens(cfg, p, tokens)
    S = max_len or T
    positions = torch.arange(T, device=tokens.device).expand(B, T)
    cache = init_cache(cfg, B, S, device=tokens.device)
    for l, win in enumerate(_windows(cfg)):
        lp = _layer(p["layers"], l)
        h = L.apply_norm(cfg, lp["ln1"], x)
        q, k, v = L.attention_qkv(lp["attn"], h, a, positions)
        # the kernel takes the JAX flash layout (B, H, T, d) / (B, KH, S, d)
        o = OPS.flash_attention(
            q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
            v.transpose(1, 2).contiguous(), causal=True, window=win,
            softcap=a.logit_softcap, scale=a.attn_scale).transpose(1, 2)
        cache.k[l, :, :T] = k
        cache.v[l, :, :T] = v
        x = _layer_tail(cfg, lp, x, L.attention_out(lp["attn"], o))
    cache.pos.fill_(T)
    x = L.apply_norm(cfg, p["final_norm"], x)
    return unembed(cfg, p, x[:, -1:, :])[:, 0], cache


# ---------------------------------------------------------------------------
# Serve fast path: per-slot cache insertion + paged multi-step decode
# ---------------------------------------------------------------------------

def cache_insert(cache: Cache, slot_cache: Cache, slot) -> Cache:
    """Write the (batch=n) ``slot_cache`` into batch rows ``slot`` of
    ``cache``, in place.  ``slot`` is an int or n slot indices (host ints,
    a numpy array or a CPU tensor).  An index >= the batch marks a padding
    row and is dropped, as JAX drops out-of-bounds scatter updates; torch
    indexing would raise on it instead."""
    slots = np.atleast_1d(np.asarray(slot, np.int64))
    B = cache.k.shape[1]
    if slots.shape[0] != slot_cache.k.shape[1]:
        raise ValueError(f"{slots.shape[0]} slots for a slot cache of batch "
                         f"{slot_cache.k.shape[1]}")
    if (slots < 0).any():
        raise ValueError(f"negative slot index in {slots.tolist()}")
    keep = slots < B
    dev = cache.k.device
    dst = torch.as_tensor(slots[keep], device=dev)
    src = torch.as_tensor(np.nonzero(keep)[0], device=dev)
    cache.k[:, dst] = slot_cache.k[:, src].to(cache.k.dtype)
    cache.v[:, dst] = slot_cache.v[:, src].to(cache.v.dtype)
    torch.maximum(cache.pos, slot_cache.pos, out=cache.pos)
    return cache


def decode_step_paged(cfg: ModelConfig, p, cache: Cache, tokens, seq_lens,
                      active, *, tables=None):
    """One decode step with PER-SLOT cache lengths (continuous batching).

    tokens (B,) int — previous token per slot; seq_lens (B,) int32 — valid
    cached tokens per slot (the new token is written at this row, then
    attended); active (B,) bool — slots past their budget keep their
    seq_len (their lane still computes; the caller discards its output).

    ``tables`` (B, nb) int32 switches to the pooled cache of `init_kv_pool`
    (k, v (L, NB, bs, KH, hd)): the new token's KV goes to pool row
    ``tables[b, pos // bs] * bs + pos % bs`` (pos = min(seq_len, nb*bs-1);
    a row outside the pool is dropped) and attention runs through
    ``ops.paged_decode_attention_bt``.

    Returns (logits (B, V), cache (updated in place), seq_lens + active).
    """
    _require_dense(cfg)
    a = cfg.attention
    B = tokens.shape[0]
    seq_lens = seq_lens.to(torch.int32)
    x = embed_tokens(cfg, p, tokens[:, None])            # (B, 1, D)
    q_pos = seq_lens[:, None]                            # per-slot positions
    if tables is None:
        S = cache.k.shape[2]
        rows = torch.arange(B, device=tokens.device)
        # frozen slots write a garbage row one past their (frozen) length —
        # never read, and overwritten by the next admission's cache_insert
        idx = seq_lens.clamp(max=S - 1).long()
        lens_now = (seq_lens + 1).clamp(max=S)
    else:
        tables = tables.to(torch.int32).contiguous()
        NB, bs = cache.k.shape[1], cache.k.shape[2]
        W = tables.shape[1] * bs
        # overflow clamps into the slot's last block, as in the dense cache
        pos = seq_lens.clamp(max=W - 1).long()
        phys = tables.long().gather(1, (pos // bs)[:, None])[:, 0]
        src, at, any_kept = _pool_writes(phys * bs + pos % bs, NB * bs)
        lens_now = (seq_lens + 1).clamp(max=W)
    for l, win in enumerate(_windows(cfg)):
        lp = _layer(p["layers"], l)
        h = L.apply_norm(cfg, lp["ln1"], x)
        q, k, v = L.attention_qkv(lp["attn"], h, a, q_pos)
        kc, vc = cache.k[l], cache.v[l]
        kw = dict(window=win, softcap=a.logit_softcap, scale=a.attn_scale)
        if tables is None:
            kc[rows, idx] = k[:, 0].to(kc.dtype)
            vc[rows, idx] = v[:, 0].to(vc.dtype)
            o = OPS.paged_decode_attention(q[:, 0], kc, vc, lens_now, **kw)
        else:
            _write_rows(kc.flatten(0, 1), src, at, any_kept, k[:, 0])
            _write_rows(vc.flatten(0, 1), src, at, any_kept, v[:, 0])
            o = OPS.paged_decode_attention_bt(q[:, 0], kc, vc, lens_now,
                                              tables, **kw)
        x = _layer_tail(cfg, lp, x, L.attention_out(lp["attn"], o[:, None]))
    act_i = active.to(torch.int32)
    torch.maximum(cache.pos, (seq_lens + act_i).max(), out=cache.pos)
    x = L.apply_norm(cfg, p["final_norm"], x)
    return unembed(cfg, p, x)[:, 0], cache, seq_lens + act_i


def pool_view(pool: Cache, tables) -> Cache:
    """Each slot's logical view (L, B, nb * bs, KH, hd) of the pooled
    cache, gathered with the table clamped to [0, NB - 1] (an unadmitted
    slot's view is whatever that block holds; its lanes are masked).  It
    shares ``pool.pos``."""
    return Cache(k=REF.pool_rows(pool.k, tables, dim=1),
                 v=REF.pool_rows(pool.v, tables, dim=1), pos=pool.pos)


def _write_back(pool: Cache, view: Cache, tables, lens0, budget,
                num_steps: int) -> None:
    """Copy the rows a chunk decoded on `pool_view`'s ``view`` into the
    pool, in place: slot b wrote logical row ``lens0[b] + i`` at step i for
    its first min(budget, num_steps) steps, clamped to the last lane (the
    last write there wins); a row outside the pool is dropped.  The rows lie
    past each prompt, in the slot's private blocks."""
    Ls, NB, bs = pool.k.shape[:3]
    B, nb = tables.shape
    W = nb * bs
    i = torch.arange(num_steps, device=tables.device)[None, :]
    n = budget.long().clamp(max=num_steps)[:, None]
    rows = lens0.long()[:, None] + i                      # (B, steps)
    rowc = rows.clamp(max=W - 1)
    keep = (i < n) & ((rows < W - 1) | (i == n - 1))
    phys = tables.long().gather(1, rowc // bs)
    dest = torch.where(keep, phys * bs + rowc % bs, NB * bs).reshape(-1)
    src, at, any_kept = _pool_writes(dest, NB * bs)
    b_idx = torch.arange(B, device=tables.device).repeat_interleave(num_steps)
    for x, y in ((pool.k, view.k), (pool.v, view.v)):
        _write_rows(x.flatten(1, 2), src, at, any_kept,
                    y[:, b_idx, rowc.reshape(-1)])


def prefill_suffix(cfg: ModelConfig, p, cache: Cache, tokens, start, valid,
                   tables) -> Tuple[torch.Tensor, Cache]:
    """Fixed-width suffix prefill over a pooled KV cache (`init_kv_pool`).

    tokens (B, T) int: row b holds the suffix tokens of logical positions
    ``[start[b], start[b] + valid[b])``, left-aligned (lanes past ``valid``
    are padding: their KV is computed and dropped); start (B,) int: the
    logical position of ``tokens[:, 0]``; valid (B,) int: valid tokens of
    the row this dispatch (0 = an idle row); tables (B, nb) int32: slot
    block tables (an entry outside the pool marks an unadmitted slot).

    Each layer first writes the fresh suffix KV into its pool rows (padding
    lanes, idle rows and rows past the table go to a row outside the pool
    and are dropped, `_pool_writes`), then gathers the slot's whole logical
    view (nb * bs lanes: blocks of earlier dispatches or of a shared prefix,
    and this chunk) and runs `layers.blocked_attention` with logical
    positions; lanes at or past ``start + valid`` carry the kv position -1
    and contribute exact zeros.  A lane's result does not depend on its
    row in the dispatch or on how many lanes of the view are valid, so a
    long suffix prefills in chained dispatches of one shape, at any offset,
    with the same bits.  The pool is updated in place.

    Returns (logits (B, V) f32 at each row's last valid position, cache).
    """
    _require_dense(cfg)
    a = cfg.attention
    dev = cache.k.device
    i32 = dict(dtype=torch.int32, device=dev)
    tokens = torch.as_tensor(tokens, device=dev).long()
    start, valid = (torch.as_tensor(x, **i32) for x in (start, valid))
    tables = torch.as_tensor(tables, **i32)
    B, T = tokens.shape
    NB, bs, KH, hd = cache.k.shape[1:]
    nb = tables.shape[1]
    W = nb * bs
    x = embed_tokens(cfg, p, tokens)
    lanes = torch.arange(T, **i32)[None, :]
    positions = start[:, None] + lanes                          # (B, T)
    # the slot's view: lanes at/after the suffix end hold nothing yet
    view = torch.arange(W, **i32)[None, :]
    kv_pos = torch.where(view < (start + valid)[:, None], view, -1)
    gidx = ((tables.clamp(0, NB - 1).long() * bs)[:, :, None]
            + torch.arange(bs, device=dev)[None, None]).reshape(-1)
    blk = positions // bs
    phys = tables.long().gather(1, blk.clamp(0, nb - 1).long())
    dest = torch.where((lanes < valid[:, None]) & (blk < nb),
                       phys * bs + positions % bs, NB * bs).reshape(-1)
    src, at, any_kept = _pool_writes(dest, NB * bs)
    for l, win in enumerate(_windows(cfg)):
        lp = _layer(p["layers"], l)
        h = L.apply_norm(cfg, lp["ln1"], x)
        q, k, v = L.attention_qkv(lp["attn"], h, a, positions)
        kf, vf = cache.k[l].flatten(0, 1), cache.v[l].flatten(0, 1)
        _write_rows(kf, src, at, any_kept, k.reshape(B * T, KH, hd))
        _write_rows(vf, src, at, any_kept, v.reshape(B * T, KH, hd))
        o = L.blocked_attention(
            q, kf[gidx].reshape(B, W, KH, hd), vf[gidx].reshape(B, W, KH, hd),
            positions, kv_pos, window=win, softcap=a.logit_softcap,
            scale=a.attn_scale, kv_chunk=max(W, 1024))
        x = _layer_tail(cfg, lp, x, L.attention_out(lp["attn"], o))
    x = L.apply_norm(cfg, p["final_norm"], x)
    last = (valid - 1).clamp(0, T - 1).long()
    x = x.gather(1, last[:, None, None].expand(B, 1, x.shape[-1]))
    return unembed(cfg, p, x)[:, 0], cache


# ---------------------------------------------------------------------------
# Sampling: counter-based draws keyed by (seed, salt, position)
# ---------------------------------------------------------------------------
# The reference folds a JAX PRNG key per (salt, position) and draws with
# jax.random.categorical.  The port keys a counter-based hash the same way
# and takes the Gumbel-max of the logits: each draw depends only on
# (seed, salt, position, vocab index), so sampled streams are
# chunk-invariant, need no host sync, and match between CPU and card.  The
# numbers differ from JAX's; tests hold the property, not the tokens.

_M32 = 0xFFFFFFFF


def _mix32(x):
    """32-bit integer finaliser on int64 tensors holding values < 2**32
    (every product stays under 2**63)."""
    x = ((x ^ (x >> 16)) * 0x45D9F3B) & _M32
    x = ((x ^ (x >> 16)) * 0x45D9F3B) & _M32
    return x ^ (x >> 16)


def _fold(key, data):
    return _mix32((key * 0x2545F49 + _mix32(data & _M32)) & _M32)


def sample(logits, seed: int, salt, pos, temperature: float = 1.0):
    """Categorical draw per row of ``logits`` (B, V), keyed by
    (seed, salt[b], pos[b])."""
    B, V = logits.shape
    dev = logits.device
    key = _fold(torch.full((B,), seed & _M32, dtype=torch.int64, device=dev),
                salt.to(torch.int64))
    key = _fold(key, pos.to(torch.int64))
    bits = _fold(key[:, None], torch.arange(V, device=dev)[None, :])
    u = (bits.double() + 0.5) * 2.0 ** -32                 # in (0, 1)
    gumbel = -torch.log(-torch.log(u))
    lg = logits.double() / max(temperature, 1e-6)
    return torch.argmax(lg + gumbel, dim=-1).to(torch.int32)


def decode_n(cfg: ModelConfig, p, cache: Cache, tokens, seq_lens, budget, *,
             num_steps: int, greedy: bool = True, seed: Optional[int] = None,
             temperature: float = 1.0, salt=None, tables=None):
    """Advance all slots up to ``num_steps`` tokens; the host syncs once,
    when the caller reads the returned tokens.

    Per-slot done-masking: slot b decodes exactly ``budget[b]`` tokens, then
    its seq_len freezes and its emitted token repeats.  Greedy outputs are
    bitwise identical for any ``num_steps`` split of one trajectory.
    Sampling (``greedy=False``) needs ``seed``; ``salt`` (B,) is a
    per-request value (default: the slot index).

    ``tables`` (B, nb) int32 decodes over the pooled cache of
    `init_kv_pool`, as the reference does: each slot's logical view is
    gathered ONCE (`pool_view`), the steps run on it as on a per-slot
    cache (``ops.paged_decode_attention``), and the rows they wrote go back
    to the pool at the end (`_write_back`).  So the chunk equals the
    per-slot decode on the gathered view, bit for bit.

    Returns (toks (num_steps, B) int32, cache, seq_lens, last_tokens).
    """
    if not greedy and seed is None:
        raise ValueError("sampling decode (greedy=False) needs a seed")
    dev = cache.k.device
    budget = torch.as_tensor(budget, dtype=torch.int32, device=dev)
    salt = (torch.as_tensor(salt, dtype=torch.int32, device=dev)
            if salt is not None
            else torch.arange(budget.shape[0], dtype=torch.int32, device=dev))
    toks = torch.as_tensor(tokens, dtype=torch.int32, device=dev)
    lens = lens0 = torch.as_tensor(seq_lens, dtype=torch.int32, device=dev)
    pool = None
    if tables is not None:
        tables = torch.as_tensor(tables, dtype=torch.int32, device=dev)
        pool, cache = cache, pool_view(cache, tables)
    produced = torch.zeros_like(budget)
    out = []
    for _ in range(num_steps):
        active = produced < budget
        logits, cache, lens = decode_step_paged(cfg, p, cache, toks, lens,
                                                active)
        if greedy:
            pick = torch.argmax(logits, dim=-1).to(torch.int32)
        else:
            pick = sample(logits, seed, salt, lens, temperature)
        toks = torch.where(active, pick, toks)
        produced = produced + active.to(torch.int32)
        out.append(toks)
    if pool is not None:
        _write_back(pool, cache, tables, lens0, budget, num_steps)
        cache = pool
    return torch.stack(out), cache, lens, toks
