"""Decoder stack of the port (dense, MoE, SSM, hybrid and VLM families): init,
the training forward, prefill, paged decode, decode_n, over a per-slot
cache or, for the dense family, a pooled block-table one (`init_kv_pool`,
`prefill_suffix`).

Ports of ``repro/models/transformer.py`` for those families.
A MoE model's stacked layers carry ``moe`` in place of ``mlp``
(``models/moe.py``); its dense prefix (kimi-k2) is the unstacked list
``dense_prefix`` with its own KV (``Cache.prefix_k/v``), run before the
stack with global windows, as the reference unrolls it.  A VLM
(internvl2) is a dense decoder whose ``forward`` and ``prefill`` prepend
``batch["patches"] @ vision_proj`` (bf16) to the token embeddings, so its
positions and cache rows run over the P patch positions, then the T
tokens; it serves and does not train yet.  An SSM model
(mamba2) has ``ln1`` and the SSD block ``ssm`` a layer and no FFN; a
hybrid one (hymba) runs attention and the SSD block side by side on the
same normed input and mixes them as ``0.5 * (attn * (1 + alpha_attn) +
ssm * (1 + alpha_ssm))`` in the activation dtype, then its MLP.  Their
recurrent state lives in ``Cache.ssm`` (L, B, H, P, N) f32 and
``Cache.conv`` (L, B, W-1, conv_dim) bf16 (``models/ssm.py``).  JAX scans a
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
    bitwise chunk-invariant; a frozen slot's SSM state and conv history
    are kept as they were, bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as OPS
from repro_torch.kernels import ref as REF
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import quant as Q
from repro_torch.models import ssm as SSM

GLOBAL_WINDOW = 1 << 30


# the decoder-only families that train and serve
DECODER_FAMILIES = ("dense", "moe", "ssm", "hybrid")
# ... and those that serve: a VLM's training waits for ROADMAP.md queue 1,
# item 11(i)
SERVE_FAMILIES = DECODER_FAMILIES + ("vlm",)


def _require_decoder(cfg: ModelConfig) -> None:
    if cfg.vision_prefix and cfg.family != "vlm":
        raise NotImplementedError(
            f"a vision prefix belongs to the vlm family, not to {cfg.name} "
            f"({cfg.family})")
    if (cfg.family not in SERVE_FAMILIES
            or (cfg.attention is None) != (cfg.family == "ssm")):
        raise NotImplementedError(
            f"models.transformer runs the dense, MoE, SSM, hybrid and VLM "
            f"decoders, not {cfg.name} ({cfg.family})")


def _require_dense(cfg: ModelConfig) -> None:
    """The pooled prefix-shared KV cache: dense attention families only,
    as the reference asserts."""
    _require_decoder(cfg)
    if cfg.family != "dense":
        raise NotImplementedError(
            f"pooled prefix-shared KV is dense-transformer only, not "
            f"{cfg.name} ({cfg.family})")


def num_moe_layers(cfg: ModelConfig) -> int:
    return cfg.num_layers - (cfg.moe.dense_layers if cfg.moe else 0)


def _n_scan(cfg: ModelConfig) -> int:
    """Layers of the stacked ``p["layers"]``: all of them, or a MoE
    model's layers after its dense prefix."""
    return num_moe_layers(cfg) if cfg.family == "moe" else cfg.num_layers


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
    """Window of each stacked layer as the kernels take it: None for a
    global layer.  A MoE model's stack starts after its dense prefix
    (whose layers are global)."""
    return [None if w >= GLOBAL_WINDOW else int(w)
            for w in window_schedule(cfg)[cfg.num_layers - _n_scan(cfg):]]


def _layer(tree, l: int):
    """Layer ``l`` of a stacked param tree (empty dicts stay empty; an int8
    `quant.QTensor` leaf gives layer ``l`` of its values and scales)."""
    if isinstance(tree, dict):
        return {k: _layer(v, l) for k, v in tree.items()}
    if isinstance(tree, Q.QTensor):
        return Q.QTensor(tree.q[l], tree.scale[l], tree.tile)
    return tree[l]


def fill(tree, value):
    """``tree``'s nesting with ``value`` at every leaf."""
    if isinstance(tree, dict):
        return {k: fill(v, value) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(fill(v, value) for v in tree)
    return value


def stacked(p):
    """``p``'s tree with True at the leaves stacked by layer along dim 0
    (those of ``p["layers"]``) and False elsewhere.  In place of a stacked
    leaf, `forward` also takes the list of its per-layer slices: `_layer`
    indexes either alike."""
    return {k: fill(v, k == "layers") for k, v in p.items()}


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _norm_init(cfg: ModelConfig, lead, device, dtype):
    shape = tuple(lead) + (cfg.d_model,)
    if cfg.norm == "nonparam_ln":
        return {}
    if cfg.norm == "layernorm":
        return {"w": torch.ones(shape, device=device, dtype=dtype),
                "b": torch.zeros(shape, device=device, dtype=dtype)}
    return {"w": torch.zeros(shape, device=device, dtype=dtype)}


def attention_init(cfg: ModelConfig, gen, lead, device, dtype, *,
                   cross: bool = False):
    """Attention projections stacked over ``lead``; qkv biases (zeros)
    where the config has them, never for ``cross`` attention (the
    reference's ``attention_init``)."""
    a = cfg.attention
    d = cfg.d_model
    H, KH, hd = a.num_heads, a.num_kv_heads, a.head_dim

    def tn(*shape):
        return L.trunc_normal(gen, lead + shape, shape[0], device, dtype)

    attn = {"wq": tn(d, H, hd), "wk": tn(d, KH, hd), "wv": tn(d, KH, hd),
            "wo": tn(H * hd, d)}
    if a.qkv_bias and not cross:
        attn.update({k: torch.zeros(lead + (h, hd), device=device,
                                    dtype=dtype)
                     for k, h in (("bq", H), ("bk", KH), ("bv", KH))})
    return attn


def _block_init(cfg: ModelConfig, gen, lead, d_ff, device, dtype):
    """One pre-norm block's attention and norms (stacked over ``lead``),
    with a dense MLP of width ``d_ff``, or none for ``d_ff=None``."""
    d = cfg.d_model

    def tn(*shape):
        return L.trunc_normal(gen, lead + shape, shape[0], device, dtype)

    blk = {"ln1": _norm_init(cfg, lead, device, dtype),
           "attn": attention_init(cfg, gen, lead, device, dtype),
           "ln2": _norm_init(cfg, lead, device, dtype)}
    if d_ff is not None:
        mlp = {"wo": tn(d_ff, d)}
        if cfg.ffn_glu:
            mlp.update(wg=tn(d, d_ff), wu=tn(d, d_ff))
        else:
            mlp["wi"] = tn(d, d_ff)
        blk["mlp"] = mlp
    return blk


def init_params(cfg: ModelConfig, gen: torch.Generator, *, device,
                dtype=torch.bfloat16) -> Dict[str, Any]:
    """Random params in the JAX layout (see ``interop``), from ``gen``.
    Same distributions as the reference's ``init_params``, not the same
    numbers: JAX's PRNG is not reproduced.  A MoE model's stacked layers
    hold ``moe`` (``moe.moe_init``) in place of ``mlp``, and its dense
    prefix is the list ``dense_prefix`` of unstacked blocks.  An SSM
    model's layers hold ``ln1`` and ``ssm`` (``ssm.ssd_init``); a hybrid
    model's add ``ssm`` and the f32 zeros ``alpha_attn``, ``alpha_ssm``
    (L, d) to a dense block.  A VLM adds ``vision_proj``
    (vision_dim, d)."""
    _require_decoder(cfg)
    d, n = cfg.d_model, _n_scan(cfg)
    moe = cfg.family == "moe"
    if cfg.family == "ssm":
        layers = {"ln1": _norm_init(cfg, (n,), device, dtype)}
    else:
        layers = _block_init(cfg, gen, (n,), None if moe else cfg.d_ff,
                             device, dtype)
    if cfg.family in ("ssm", "hybrid"):
        layers["ssm"] = SSM.ssd_init(cfg, gen, stacked=n, device=device,
                                     dtype=dtype)
    if cfg.family == "hybrid":
        for k in ("alpha_attn", "alpha_ssm"):
            layers[k] = torch.zeros((n, d), dtype=torch.float32,
                                    device=device)
    if moe:
        layers["moe"] = MOE.moe_init(cfg, gen, stacked=n, device=device,
                                     dtype=dtype)
    if cfg.post_norm:
        layers["post_ln1"] = _norm_init(cfg, (n,), device, dtype)
        layers["post_ln2"] = _norm_init(cfg, (n,), device, dtype)
    p = {"embed": torch.randn((cfg.vocab_size, d), generator=gen,
                              device=device).to(dtype),
         "final_norm": _norm_init(cfg, (), device, dtype),
         "layers": layers}
    if not cfg.tie_embeddings:
        p["head"] = L.trunc_normal(gen, (d, cfg.vocab_size), d, device,
                                   dtype)
    if cfg.vision_prefix:
        p["vision_proj"] = L.trunc_normal(gen, (cfg.vision_dim, d),
                                          cfg.vision_dim, device, dtype)
    if moe and cfg.moe.dense_layers:
        p["dense_prefix"] = [
            _block_init(cfg, gen, (), cfg.moe.dense_ffw, device, dtype)
            for _ in range(cfg.moe.dense_layers)]
    return p


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

def embed_tokens(cfg: ModelConfig, p, tokens, dtype=torch.bfloat16):
    x = Q.take(p["embed"], tokens, dtype)
    if cfg.embed_scale:
        x = x * torch.tensor(np.sqrt(cfg.d_model), dtype=dtype)
    return x


def embed_inputs(cfg: ModelConfig, p, batch, dtype=torch.bfloat16):
    """The residual stream's input (B, P + T, D): a VLM's projected patches
    ``batch["patches"] @ vision_proj`` (bf16 operands, as the reference's
    einsum) before the T token embeddings; P = 0 for the other
    families."""
    x = embed_tokens(cfg, p, batch["tokens"], dtype)
    if cfg.vision_prefix:
        pv = torch.einsum("bpe,ed->bpd", batch["patches"].to(dtype),
                          Q.cast(p["vision_proj"], dtype))
        x = torch.cat([pv, x], dim=1)
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
    k: Optional[torch.Tensor] = None     # (L, B, S, KH, hd); None for SSM
    v: Optional[torch.Tensor] = None
    pos: Optional[torch.Tensor] = None   # () int32: tokens already cached
    # a MoE model's dense prefix: one (B, S, KH, hd) per prefix layer
    prefix_k: Optional[List[torch.Tensor]] = None
    prefix_v: Optional[List[torch.Tensor]] = None
    # SSM and hybrid: the SSD state (L, B, H, P, N) f32 and the raw conv
    # history (L, B, W-1, conv_dim) bf16 of each layer
    ssm: Optional[torch.Tensor] = None
    conv: Optional[torch.Tensor] = None

    @property
    def batch(self) -> int:
        return (self.k if self.k is not None else self.ssm).shape[1]


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, device,
               dtype=torch.bfloat16) -> Cache:
    _require_decoder(cfg)
    a = cfg.attention
    n = _n_scan(cfg)
    c = Cache(pos=torch.zeros((), dtype=torch.int32, device=device))
    if a is not None:
        kv = (n, batch, max_len, a.num_kv_heads, a.head_dim)
        c.k = torch.zeros(kv, dtype=dtype, device=device)
        c.v = torch.zeros(kv, dtype=dtype, device=device)
        npre = cfg.num_layers - n
        if npre:
            c.prefix_k = [torch.zeros(kv[1:], dtype=dtype, device=device)
                          for _ in range(npre)]
            c.prefix_v = [torch.zeros(kv[1:], dtype=dtype, device=device)
                          for _ in range(npre)]
    if cfg.family in ("ssm", "hybrid"):
        state, conv = SSM.init_ssm_state(cfg, batch, device=device)
        c.ssm = state.expand((n,) + state.shape).contiguous()
        c.conv = conv.expand((n,) + conv.shape).contiguous()
    return c


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

def _mix(lp, ha, hs):
    """The token mixer's output from the attention output ``ha`` and the
    SSD output ``hs`` (either None where the family has none): a hybrid
    layer's ``0.5 * (ha * (1 + alpha_attn) + hs * (1 + alpha_ssm))``, in
    ``ha``'s dtype, op by op as the reference."""
    if hs is None:
        return ha
    if ha is None:
        return hs
    dt = ha.dtype
    return 0.5 * (ha * (1.0 + lp["alpha_attn"].to(dt))
                  + hs * (1.0 + lp["alpha_ssm"].to(dt)))


def _layer_tail(cfg: ModelConfig, lp, x, h, *, decode: bool = False):
    """Residual add of the mixer output ``h``, then the FFN block: the
    dense MLP, or the MoE layer (``moe.moe_ep``, or ``moe.moe_decode`` for
    ``decode``); an SSM layer has none.  Returns (x, aux): the MoE
    load-balance loss, None for a dense MLP."""
    if cfg.post_norm:
        h = L.apply_norm(cfg, lp["post_ln1"], h)
    x = x + h
    if cfg.family == "ssm":
        return x, None
    h = L.apply_norm(cfg, lp["ln2"], x)
    aux = None
    if "moe" in lp:
        moe_fn = MOE.moe_decode if decode else MOE.moe_ep
        h, aux, _ = moe_fn(cfg, lp["moe"], h)
    else:
        h = L.mlp_apply(cfg, lp["mlp"], h)
    if cfg.post_norm:
        h = L.apply_norm(cfg, lp["post_ln2"], h)
    return x + h, aux


def _blocks(cfg: ModelConfig, p, cache: Cache):
    """Every layer in order, as (params, window, k cache, v cache, SSD
    state, conv history): a MoE model's dense prefix (global windows,
    ``cache.prefix_k/v``), then the stacked layers (``cache.k/v[l]``,
    ``cache.ssm/conv[l]``); a cache the family lacks gives None."""
    for i, blk in enumerate(p.get("dense_prefix", [])):
        yield blk, None, cache.prefix_k[i], cache.prefix_v[i], None, None
    at = lambda c, l: None if c is None else c[l]
    for l, win in enumerate(_windows(cfg)):
        yield (_layer(p["layers"], l), win, at(cache.k, l), at(cache.v, l),
               at(cache.ssm, l), at(cache.conv, l))


# ---------------------------------------------------------------------------
# Prefill
# ---------------------------------------------------------------------------

def prefill(cfg: ModelConfig, p, batch: Dict[str, Any], *,
            max_len: Optional[int] = None) -> Tuple[torch.Tensor, Cache]:
    """Forward over the prompt; returns (last-position logits (B, V) f32,
    filled cache of length ``max_len`` (default T)).  A VLM's prompt is
    its P patch positions and T tokens: the cache holds P + T rows and
    ``max_len`` counts both.  A MoE layer routes
    all B x T tokens together (capacity counts the whole dispatch, padding
    included, as the reference's).  An SSD block runs `ssm.ssd_forward`
    over the whole prompt and leaves its final state and raw conv tail in
    the cache."""
    _require_decoder(cfg)
    tokens = batch["tokens"]
    a = cfg.attention
    x = embed_inputs(cfg, p, batch)
    B, T = x.shape[:2]
    S = max_len or T
    positions = torch.arange(T, device=tokens.device).expand(B, T)
    cache = init_cache(cfg, B, S, device=tokens.device)
    for lp, win, kc, vc, sst, scv in _blocks(cfg, p, cache):
        h = L.apply_norm(cfg, lp["ln1"], x)
        ha = hs = None
        if "attn" in lp:
            q, k, v = L.attention_qkv(lp["attn"], h, a, positions)
            # the kernel takes the JAX flash layout (B, H, T, d) /
            # (B, KH, S, d)
            o = OPS.flash_attention(
                q.transpose(1, 2).contiguous(),
                k.transpose(1, 2).contiguous(),
                v.transpose(1, 2).contiguous(), causal=True, window=win,
                softcap=a.logit_softcap, scale=a.attn_scale).transpose(1, 2)
            kc[:, :T] = k
            vc[:, :T] = v
            ha = L.attention_out(lp["attn"], o)
        if "ssm" in lp:
            hs, state, tail = SSM.ssd_forward(cfg, lp["ssm"], h)
            sst.copy_(state)
            scv.copy_(tail)
        x, _ = _layer_tail(cfg, lp, x, _mix(lp, ha, hs))
    cache.pos.fill_(T)
    x = L.apply_norm(cfg, p["final_norm"], x)
    return unembed(cfg, p, x[:, -1:, :])[:, 0], cache


# ---------------------------------------------------------------------------
# Forward (training / teacher-forced)
# ---------------------------------------------------------------------------

def attn_group_size(cfg: ModelConfig) -> int:
    """Layers a group of the qchunked path: the local/global pattern
    repeats every ``global_every`` layers, so groups of that size give every
    position of a group a static window."""
    a = cfg.attention
    if (a and a.sliding_window and a.global_every > 0
            and _n_scan(cfg) % a.global_every == 0):
        return a.global_every
    return 1


def can_qchunk(cfg: ModelConfig) -> bool:
    """qchunked attention needs static windows: no sliding windows, or a
    local/global pattern that tiles the stack exactly."""
    a = cfg.attention
    if a is None or a.sliding_window is None or a.global_every == 0:
        return True
    return _n_scan(cfg) % a.global_every == 0


def static_window_for(cfg: ModelConfig, idx_in_group: int, group: int):
    a = cfg.attention
    if a is None or a.sliding_window is None or a.global_every == 0:
        return None
    if group == 1:
        return None
    return None if idx_in_group == group - 1 else a.sliding_window


def _dense_layer(cfg: ModelConfig, lp, x, positions, window, *,
                 kv_chunk: int = 1024, attn_impl: str = "blocked"):
    """One pre-norm layer over the whole sequence (the reference's
    ``_dense_layer``): plain-torch attention and the SSD block's
    `ssm.ssd_forward`, both with a backward (the SSD's finite at chunk
    256, where the reference's is NaN).  Returns (x, aux) as
    `_layer_tail`."""
    a = cfg.attention
    h = L.apply_norm(cfg, lp["ln1"], x)
    ha = hs = None
    if "attn" in lp and attn_impl == "qchunked":
        q, k, v = L.attention_qkv(lp["attn"], h, a, positions)
        o = L.blocked_attention_qchunked(
            q, k, v, positions, positions, window=window,
            softcap=a.logit_softcap, scale=a.attn_scale, kv_chunk=kv_chunk)
        ha = L.attention_out(lp["attn"], o)
    elif "attn" in lp:
        ha = L.self_attention(lp["attn"], h, a, positions, window=window,
                              kv_chunk=kv_chunk)
    if "ssm" in lp:
        hs, _, _ = SSM.ssd_forward(cfg, lp["ssm"], h)
    return _layer_tail(cfg, lp, x, _mix(lp, ha, hs))


def forward(cfg: ModelConfig, p, batch: Dict[str, Any], *,
            kv_chunk: int = 1024, remat: bool = False,
            return_hidden: bool = False, attn_impl: str = "blocked"):
    """Teacher-forced forward -> (logits (B, T, V) f32, aux), or (final
    hidden (B, T, D), aux) with ``return_hidden`` (a VLM's T counts its P
    patch positions before the tokens).  aux is the MoE layers'
    load-balance losses summed in layer order (0.0 for the dense family);
    a MoE model's dense prefix runs first, with global windows.

    ``attn_impl="qchunked"`` (where `can_qchunk`) walks the stack in groups
    of `attn_group_size` layers with static windows, as the reference's
    regrouped scan does.  ``remat`` recomputes each layer (each group) in
    the backward pass (``torch.utils.checkpoint``, the reference's
    ``jax.checkpoint`` of the scan body): the same operations run again, so
    the loss and the gradients keep their bits."""
    _require_decoder(cfg)
    tokens = batch["tokens"]
    x = embed_inputs(cfg, p, batch)
    B, T = x.shape[:2]
    positions = torch.arange(T, device=tokens.device).expand(B, T)
    n = _n_scan(cfg)
    if attn_impl == "qchunked" and can_qchunk(cfg):
        g = attn_group_size(cfg)
        wins = [static_window_for(cfg, i % g, g) for i in range(n)]
    else:
        g, attn_impl = 1, "blocked"
        wins = _windows(cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for blk in p.get("dense_prefix", []):
        x, _ = _dense_layer(cfg, blk, x, positions, None, kv_chunk=kv_chunk)

    def group(x, aux, l0):
        for l in range(l0, l0 + g):
            x, a = _dense_layer(cfg, _layer(p["layers"], l), x, positions,
                                wins[l], kv_chunk=kv_chunk,
                                attn_impl=attn_impl)
            if a is not None:
                aux = aux + a
        return x, aux

    for l0 in range(0, n, g):
        if remat and torch.is_grad_enabled():
            x, aux = torch.utils.checkpoint.checkpoint(group, x, aux, l0,
                                                       use_reentrant=False)
        else:
            x, aux = group(x, aux, l0)
    x = L.apply_norm(cfg, p["final_norm"], x)
    if return_hidden:
        return x, aux
    return unembed(cfg, p, x), aux


# ---------------------------------------------------------------------------
# Serve fast path: per-slot cache insertion + paged multi-step decode
# ---------------------------------------------------------------------------

def cache_insert(cache: Cache, slot_cache: Cache, slot) -> Cache:
    """Write the (batch=n) ``slot_cache`` into batch rows ``slot`` of
    ``cache``, in place: its KV rows, SSD states and conv histories.
    ``slot`` is an int or n slot indices (host ints, a numpy array or a
    CPU tensor).  An index >= the batch marks a padding row and is
    dropped, as JAX drops out-of-bounds scatter updates; torch indexing
    would raise on it instead."""
    slots = np.atleast_1d(np.asarray(slot, np.int64))
    B = cache.batch
    if slots.shape[0] != slot_cache.batch:
        raise ValueError(f"{slots.shape[0]} slots for a slot cache of batch "
                         f"{slot_cache.batch}")
    if (slots < 0).any():
        raise ValueError(f"negative slot index in {slots.tolist()}")
    keep = slots < B
    dev = cache.pos.device
    dst = torch.as_tensor(slots[keep], device=dev)
    src = torch.as_tensor(np.nonzero(keep)[0], device=dev)
    for name in ("k", "v", "ssm", "conv"):
        c = getattr(cache, name)
        if c is not None:
            c[:, dst] = getattr(slot_cache, name)[:, src].to(c.dtype)
    for lists in ("prefix_k", "prefix_v"):
        for c, sc in zip(getattr(cache, lists) or (),
                         getattr(slot_cache, lists) or ()):
            c[dst] = sc[src].to(c.dtype)
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
    ``ops.paged_decode_attention_bt`` (dense family only).

    A MoE model runs its dense prefix first (global windows, its own
    per-slot cache), then its MoE layers through ``moe.moe_decode``: every
    lane routes, frozen ones too (their repeat token takes capacity, as in
    the reference).  An SSD block advances by `ssm.ssd_step`; a frozen
    lane keeps its state and conv history, bit for bit.

    Returns (logits (B, V), cache (updated in place), seq_lens + active).
    """
    (_require_decoder if tables is None else _require_dense)(cfg)
    a = cfg.attention
    B = tokens.shape[0]
    seq_lens = seq_lens.to(torch.int32)
    x = embed_tokens(cfg, p, tokens[:, None])            # (B, 1, D)
    q_pos = seq_lens[:, None]                            # per-slot positions
    if tables is None and cache.k is not None:
        S = cache.k.shape[2]
        rows = torch.arange(B, device=tokens.device)
        # frozen slots write a garbage row one past their (frozen) length —
        # never read, and overwritten by the next admission's cache_insert
        idx = seq_lens.clamp(max=S - 1).long()
        lens_now = (seq_lens + 1).clamp(max=S)
    elif tables is not None:
        tables = tables.to(torch.int32).contiguous()
        NB, bs = cache.k.shape[1], cache.k.shape[2]
        W = tables.shape[1] * bs
        # overflow clamps into the slot's last block, as in the dense cache
        pos = seq_lens.clamp(max=W - 1).long()
        phys = tables.long().gather(1, (pos // bs)[:, None])[:, 0]
        src, at, any_kept = _pool_writes(phys * bs + pos % bs, NB * bs)
        lens_now = (seq_lens + 1).clamp(max=W)
    for lp, win, kc, vc, sst, scv in _blocks(cfg, p, cache):
        h = L.apply_norm(cfg, lp["ln1"], x)
        ha = hs = None
        if "attn" in lp:
            q, k, v = L.attention_qkv(lp["attn"], h, a, q_pos)
            kw = dict(window=win, softcap=a.logit_softcap, scale=a.attn_scale)
            if tables is None:
                kc[rows, idx] = k[:, 0].to(kc.dtype)
                vc[rows, idx] = v[:, 0].to(vc.dtype)
                o = OPS.paged_decode_attention(q[:, 0], kc, vc, lens_now,
                                               **kw)
            else:
                _write_rows(kc.flatten(0, 1), src, at, any_kept, k[:, 0])
                _write_rows(vc.flatten(0, 1), src, at, any_kept, v[:, 0])
                o = OPS.paged_decode_attention_bt(q[:, 0], kc, vc, lens_now,
                                                  tables, **kw)
            ha = L.attention_out(lp["attn"], o[:, None])
        if "ssm" in lp:
            o, state, conv = SSM.ssd_step(cfg, lp["ssm"], h[:, 0], sst, scv)
            sst.copy_(torch.where(active[:, None, None, None], state, sst))
            scv.copy_(torch.where(active[:, None, None], conv, scv))
            hs = o[:, None, :]
        x, _ = _layer_tail(cfg, lp, x, _mix(lp, ha, hs), decode=True)
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
        x, _ = _layer_tail(cfg, lp, x, L.attention_out(lp["attn"], o))
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
    dev = cache.pos.device
    budget = torch.as_tensor(budget, dtype=torch.int32, device=dev)
    salt = (torch.as_tensor(salt, dtype=torch.int32, device=dev)
            if salt is not None
            else torch.arange(budget.shape[0], dtype=torch.int32, device=dev))
    toks = torch.as_tensor(tokens, dtype=torch.int32, device=dev)
    lens = lens0 = torch.as_tensor(seq_lens, dtype=torch.int32, device=dev)
    pool = None
    if tables is not None:
        _require_dense(cfg)
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
