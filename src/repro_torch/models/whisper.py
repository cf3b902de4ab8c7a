"""Whisper-small backbone of the port (``repro/models/whisper.py``): a
transformer encoder over stub frame embeddings and a causal decoder with
cross-attention.

The conv/mel frontend is a stub, as in the reference: ``batch["frames"]``
holds precomputed frame embeddings (B, S_enc, d_model).  RoPE replaces
learned positions on the self-attention (encoder and decoder); the
cross-attention projects q, k and v with bare einsums and rotates
nothing.  The param tree is the reference's (``interop``):

    embed (V, d)  enc_final_norm, final_norm {w, b}  head (untied only)
    encoder/{ln1, attn, ln2, mlp}           stacked over encoder_layers
    decoder/{ln1, attn, ln_x, xattn, ln2, mlp}  stacked over num_layers

Attention.  `forward` (teacher-forced) keeps the reference's plain
``layers.blocked_attention`` everywhere.  `prefill` runs every attention
through ``kernels/ops.py``'s ``flash_attention`` (row 2): the encoder's
non-causal over S_enc frames, the decoder's causal over its T tokens, the
cross-attention non-causal, T queries over S_enc keys.  `decode_step`
runs both through ``paged_decode_attention`` (row 1): the self-attention
over ``min(pos + 1, S)`` rows of every slot, the cross-attention over the
static S_enc rows of ``xk``/``xv``.  The caches are already row 1's
(B, S, KH, hd) layout a layer.

One cache position ``pos`` serves the whole batch (the legacy full-batch
engine re-prefills every slot on admission).  Past the cache's last row
the decode write clamps to row S - 1, as ``jax.lax.dynamic_update_slice``
clamps its start: the step overwrites that row and carries on, with q
still rotated to the true position.  The port writes the caches IN PLACE
(`decode_step` returns the cache it was given, updated).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as OPS
from repro_torch.models import layers as L
from repro_torch.models import quant as Q
from repro_torch.models import transformer as TF


def split_seq(cfg: ModelConfig, seq_len: int) -> Tuple[int, int]:
    """A cell's ``seq_len`` as (encoder frames, decoder tokens): halves,
    each at least 2, summing to ``seq_len`` (for ``seq_len >= 4``)."""
    enc = max(2, seq_len // 2)
    dec = max(2, seq_len - enc)
    return enc, dec


def init_params(cfg: ModelConfig, gen: torch.Generator, *, device,
                dtype=torch.bfloat16) -> Dict[str, Any]:
    """Random params in the reference's layout, from ``gen``: the
    reference's distributions, not its numbers.  The cross-attention has
    no qkv bias (the reference's ``attention_init(cross=True)``)."""
    Le, Ld = cfg.encoder_layers, cfg.num_layers
    enc = TF._block_init(cfg, gen, (Le,), cfg.d_ff, device, dtype)
    dec = TF._block_init(cfg, gen, (Ld,), cfg.d_ff, device, dtype)
    dec["ln_x"] = TF._norm_init(cfg, (Ld,), device, dtype)
    dec["xattn"] = TF.attention_init(cfg, gen, (Ld,), device, dtype,
                                     cross=True)
    p = {"embed": torch.randn((cfg.vocab_size, cfg.d_model), generator=gen,
                              device=device).to(dtype),
         "enc_final_norm": TF._norm_init(cfg, (), device, dtype),
         "final_norm": TF._norm_init(cfg, (), device, dtype),
         "encoder": enc, "decoder": dec}
    if not cfg.tie_embeddings:
        p["head"] = L.trunc_normal(gen, (cfg.d_model, cfg.vocab_size),
                                   cfg.d_model, device, dtype)
    return p


def _flash(q, k, v, *, causal: bool, softcap=None, scale=None):
    """Row 2 on (B, T, H, d) q and (B, S, KH, d) k, v (the kernel takes
    the JAX flash layout (B, H, T, d)) -> (B, T, H, d)."""
    return OPS.flash_attention(
        q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
        v.transpose(1, 2).contiguous(), causal=causal, softcap=softcap,
        scale=scale).transpose(1, 2)


def _positions(n: int, batch: int, device):
    return torch.arange(n, device=device).expand(batch, n)


def _encode(cfg: ModelConfig, p, frames, *, flash: bool = False,
            kv_chunk: int = 1024):
    """frames (B, S_enc, d_model) -> the encoder output (B, S_enc, d)
    bf16.  Its self-attention is non-causal: plain ``blocked_attention``,
    or row 2 with ``flash`` (`prefill`)."""
    a = cfg.attention
    B, S, _ = frames.shape
    x = frames.to(torch.bfloat16)
    positions = _positions(S, B, frames.device)
    for l in range(cfg.encoder_layers):
        lp = TF._layer(p["encoder"], l)
        h = L.apply_norm(cfg, lp["ln1"], x)
        if flash:
            q, k, v = L.attention_qkv(lp["attn"], h, a, positions)
            h = L.attention_out(lp["attn"], _flash(
                q, k, v, causal=False, softcap=a.logit_softcap,
                scale=a.attn_scale))
        else:
            h = L.self_attention(lp["attn"], h, a, positions, causal=False,
                                 kv_chunk=kv_chunk)
        x = x + h
        h = L.apply_norm(cfg, lp["ln2"], x)
        x = x + L.mlp_apply(cfg, lp["mlp"], h)
    return L.apply_norm(cfg, p["enc_final_norm"], x)


def _cross_q(lp, h):
    """Cross-attention queries (B, T, H, hd) from the decoder stream: a
    bare projection, no RoPE."""
    return torch.einsum("btd,dhk->bthk", h,
                        Q.cast(lp["wq"], h.dtype)).contiguous()


def _enc_kv(p_x, enc_out):
    """Cross-attention K/V (B, S_enc, KH, hd) from the encoder output: bare
    projections, no RoPE."""
    dt = enc_out.dtype
    k = torch.einsum("bsd,dhk->bshk", enc_out, Q.cast(p_x["wk"], dt))
    v = torch.einsum("bsd,dhk->bshk", enc_out, Q.cast(p_x["wv"], dt))
    return k, v


def forward(cfg: ModelConfig, p, batch: Dict[str, Any], *,
            kv_chunk: int = 1024):
    """Teacher-forced: batch = {frames (B, S_enc, d), tokens (B, T)} ->
    (logits (B, T, V) f32, aux 0.0).  Plain attention throughout."""
    a = cfg.attention
    enc_out = _encode(cfg, p, batch["frames"], kv_chunk=kv_chunk)
    tokens = batch["tokens"]
    B, T = tokens.shape
    S = enc_out.shape[1]
    x = TF.embed_tokens(cfg, p, tokens)
    positions = _positions(T, B, tokens.device)
    kv_pos = _positions(S, B, tokens.device)
    for l in range(cfg.num_layers):
        lp = TF._layer(p["decoder"], l)
        h = L.apply_norm(cfg, lp["ln1"], x)
        x = x + L.self_attention(lp["attn"], h, a, positions, causal=True,
                                 kv_chunk=kv_chunk)
        h = L.apply_norm(cfg, lp["ln_x"], x)
        k, v = _enc_kv(lp["xattn"], enc_out)
        o = L.blocked_attention(_cross_q(lp["xattn"], h), k, v, positions,
                                kv_pos, causal=False, scale=a.attn_scale,
                                kv_chunk=kv_chunk)
        x = x + L.attention_out(lp["xattn"], o)
        h = L.apply_norm(cfg, lp["ln2"], x)
        x = x + L.mlp_apply(cfg, lp["mlp"], h)
    x = L.apply_norm(cfg, p["final_norm"], x)
    return TF.unembed(cfg, p, x), torch.zeros((), dtype=torch.float32,
                                              device=x.device)


@dataclasses.dataclass
class WhisperCache:
    k: torch.Tensor          # (Ld, B, S_dec, KH, hd) decoder self-attention
    v: torch.Tensor
    xk: torch.Tensor         # (Ld, B, S_enc, KH, hd) cross-attention (static)
    xv: torch.Tensor
    pos: torch.Tensor        # () int32: decoder tokens already cached


def init_cache(cfg: ModelConfig, batch: int, max_len: int, enc_len: int, *,
               device, dtype=torch.bfloat16) -> WhisperCache:
    a = cfg.attention
    kv = (cfg.num_layers, batch, max_len, a.num_kv_heads, a.head_dim)
    xkv = (cfg.num_layers, batch, enc_len, a.num_kv_heads, a.head_dim)
    z = lambda shape: torch.zeros(shape, dtype=dtype, device=device)
    return WhisperCache(k=z(kv), v=z(kv), xk=z(xkv), xv=z(xkv),
                        pos=torch.zeros((), dtype=torch.int32, device=device))


def prefill(cfg: ModelConfig, p, batch: Dict[str, Any], *,
            max_len: Optional[int] = None
            ) -> Tuple[torch.Tensor, WhisperCache]:
    """Encode the frames and run the decoder over the prompt, every
    attention through row 2; returns (last-position logits (B, V) f32, the
    cache: ``max_len`` (default T) self rows, T of them filled, and the
    S_enc cross rows of each layer)."""
    a = cfg.attention
    enc_out = _encode(cfg, p, batch["frames"], flash=True)
    tokens = batch["tokens"]
    B, T = tokens.shape
    Senc = enc_out.shape[1]
    x = TF.embed_tokens(cfg, p, tokens)
    positions = _positions(T, B, tokens.device)
    cache = init_cache(cfg, B, max_len or T, Senc, device=tokens.device)
    for l in range(cfg.num_layers):
        lp = TF._layer(p["decoder"], l)
        h = L.apply_norm(cfg, lp["ln1"], x)
        q, k, v = L.attention_qkv(lp["attn"], h, a, positions)
        x = x + L.attention_out(lp["attn"], _flash(
            q, k, v, causal=True, softcap=a.logit_softcap,
            scale=a.attn_scale))
        cache.k[l, :, :T] = k
        cache.v[l, :, :T] = v
        h = L.apply_norm(cfg, lp["ln_x"], x)
        xk, xv = _enc_kv(lp["xattn"], enc_out)
        cache.xk[l] = xk
        cache.xv[l] = xv
        x = x + L.attention_out(lp["xattn"], _flash(
            _cross_q(lp["xattn"], h), xk, xv, causal=False,
            scale=a.attn_scale))
        h = L.apply_norm(cfg, lp["ln2"], x)
        x = x + L.mlp_apply(cfg, lp["mlp"], h)
    cache.pos.fill_(T)
    x = L.apply_norm(cfg, p["final_norm"], x)
    return TF.unembed(cfg, p, x[:, -1:])[:, 0], cache


def decode_step(cfg: ModelConfig, p, cache: WhisperCache, tokens
                ) -> Tuple[torch.Tensor, WhisperCache]:
    """One token for every slot at the shared position ``cache.pos``:
    tokens (B,) -> (logits (B, V) f32, the cache updated in place, pos + 1).
    The new K/V row lands at min(pos, S - 1); the self-attention reads
    min(pos + 1, S) rows and the cross-attention all S_enc, both through
    row 1.  No host sync."""
    a = cfg.attention
    B = tokens.shape[0]
    dev = tokens.device
    pos = cache.pos
    S, Senc = cache.k.shape[2], cache.xk.shape[2]
    x = TF.embed_tokens(cfg, p, tokens[:, None])          # (B, 1, D)
    q_pos = pos.expand(B)[:, None]
    row = pos.clamp(max=S - 1).long().view(1)
    lens = (pos + 1).clamp(max=S).to(torch.int32).expand(B).contiguous()
    xlens = torch.full((B,), Senc, dtype=torch.int32, device=dev)
    for l in range(cfg.num_layers):
        lp = TF._layer(p["decoder"], l)
        h = L.apply_norm(cfg, lp["ln1"], x)
        q, k, v = L.attention_qkv(lp["attn"], h, a, q_pos)
        kc, vc = cache.k[l], cache.v[l]
        kc.index_copy_(1, row, k.to(kc.dtype))
        vc.index_copy_(1, row, v.to(vc.dtype))
        o = OPS.paged_decode_attention(q[:, 0], kc, vc, lens,
                                       softcap=a.logit_softcap,
                                       scale=a.attn_scale)
        x = x + L.attention_out(lp["attn"], o[:, None])
        h = L.apply_norm(cfg, lp["ln_x"], x)
        o = OPS.paged_decode_attention(_cross_q(lp["xattn"], h)[:, 0],
                                       cache.xk[l], cache.xv[l], xlens,
                                       scale=a.attn_scale)
        x = x + L.attention_out(lp["xattn"], o[:, None])
        h = L.apply_norm(cfg, lp["ln2"], x)
        x = x + L.mlp_apply(cfg, lp["mlp"], h)
    cache.pos.add_(1)
    x = L.apply_norm(cfg, p["final_norm"], x)
    return TF.unembed(cfg, p, x)[:, 0], cache
