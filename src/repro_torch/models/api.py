"""Family-dispatching model API of the port (``repro/models/api.py``).

The dense, MoE, SSM (mamba2) and hybrid (hymba) families train
(`forward`, with the aux loss the MoE layers sum) and serve (prefill,
decode; only the dense family on the pooled KV cache, as in the
reference).  The VLM (internvl2: a dense decoder after a projected patch
prefix) and the audio family (whisper's encoder-decoder,
``models/whisper.py``) serve; their training waits for ROADMAP.md queue
1, item 11(i).  Whisper has its own cache and serves through `prefill`
and `decode_step` (the engine's legacy full-batch path), never the
per-slot `prefill_slot` / `decode_n`.  The DLRM family scores and trains
(`init_params`, `forward`, `make_batch`).  An entry point a family does
not have raises ``NotImplementedError`` naming its ROADMAP.md item.
Entry points that create tensors take ``device=`` and default to the
card: without CUDA and without ``device="cpu"`` they raise instead of
running on the CPU.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import dlrm as DL
from repro_torch.models import transformer as TF
from repro_torch.models import whisper as WH
from repro_torch.parallel.context import LOCAL, ParallelContext


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises for a CUDA device on a
    machine without one (the port never falls back to the CPU silently)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the CPU")
    return dev


_MODELS = TF.SERVE_FAMILIES + ("audio", "dlrm")


def _family(cfg: ModelConfig, *ok: str) -> None:
    """Raise unless ``cfg.family`` is one of ``ok`` (default: the decoder
    families that serve through ``models.transformer``)."""
    ok = ok or TF.SERVE_FAMILIES
    if cfg.family in ok:
        return
    if cfg.family not in _MODELS:
        raise NotImplementedError(
            f"unknown family {cfg.family!r}; the port runs {_MODELS}")
    if cfg.family == "dlrm":
        raise NotImplementedError(
            "the DLRM scores through api.forward; it has no decoder")
    if ok == ("dlrm",):                                   # make_batch
        item = ("11(i)" if cfg.family in ("audio", "vlm") else "5")
        raise NotImplementedError(
            f"api.make_batch of the {cfg.family} family waits for ROADMAP.md "
            f"queue 1, item {item}; training draws its batches from "
            f"data.synthetic.Dataset")
    if ok == ("dense",):
        raise NotImplementedError(
            "pooled prefix-shared KV is dense-transformer only")
    raise NotImplementedError(
        f"the {cfg.family} family has no {ok} entry point here")


def init_params(cfg: ModelConfig, *, seed: int = 0, device="cuda",
                dtype: Optional[torch.dtype] = None,
                ctx: ParallelContext = LOCAL):
    """Random params from a ``torch.Generator`` seeded with ``seed``, on
    ``device``, in the JAX layout.  ``dtype``: a decoder's weights
    (default bf16 for serving; ``torch.float32`` for training, the
    reference's f32 master weights, cast to bf16 at each use); a DLRM's
    params are f32, as the reference's.  ``device="meta"`` gives the
    shapes and dtypes only (`param_shapes`).  Under a ranked ``ctx`` a
    DLRM's tables are this rank's shards (``dlrm.init_params(ctx=)``); a
    decoder's params are whole on every rank.  (Weights that must equal
    the JAX package's come over through ``repro_torch.interop``.)"""
    _family(cfg, *_MODELS)
    dev = resolve_device(device)
    # a meta tensor draws nothing: any generator will do
    gen = torch.Generator(device="cpu" if dev.type == "meta" else dev)
    gen.manual_seed(seed)
    if cfg.family == "dlrm":
        if dtype not in (None, torch.float32):
            raise ValueError(f"DLRM params are float32, not {dtype}")
        return DL.init_params(cfg, gen, device=dev, ctx=ctx)
    model = WH if cfg.family == "audio" else TF
    return model.init_params(cfg, gen, device=dev,
                             dtype=dtype or torch.bfloat16)


def param_shapes(cfg: ModelConfig, dtype: Optional[torch.dtype] = None):
    """`init_params`'s tree as ``meta`` tensors: shapes and dtypes, no
    storage (what ``train.checkpoint.restore`` reads a checkpoint into)."""
    return init_params(cfg, device="meta", dtype=dtype)


def forward(cfg: ModelConfig, p, batch, **kw):
    """Dense, MoE, SSM, hybrid, VLM: -> (logits (B, T, V) f32, aux: the MoE
    load-balance losses summed, 0.0 for the others); ``remat=``,
    ``kv_chunk=``, ``return_hidden=`` and ``attn_impl=`` as
    ``transformer.forward`` (a VLM's batch carries ``patches`` and its T
    counts them).  Audio: batch {frames, tokens} -> (logits, 0.0)
    (``whisper.forward``).  DLRM: -> (logits (B,) f32, aux 0.0);
    ``fused=`` picks the lookup route (see ``models/dlrm.forward``)."""
    _family(cfg, *_MODELS)
    if cfg.family == "dlrm":
        return DL.forward(cfg, p, batch, **kw)
    if cfg.family == "audio":
        return WH.forward(cfg, p, batch, **kw)
    return TF.forward(cfg, p, batch, **kw)


def stacked(cfg: ModelConfig, p):
    """``p``'s tree with True at each leaf stacked by layer along dim 0 and
    False elsewhere (`launch.steps` takes a stacked leaf's gradient layer
    by layer): a decoder's ``p["layers"]`` (``transformer.stacked``); the
    DLRM stacks nothing."""
    if cfg.family in TF.DECODER_FAMILIES:
        return TF.stacked(p)
    return TF.fill(p, False)


def make_batch(cfg: ModelConfig, shape: ShapeConfig, *, seed: int = 0,
               device="cuda") -> Dict[str, Any]:
    """A synthetic DLRM batch of ``shape.global_batch`` samples, drawn from
    a ``torch.Generator`` seeded with ``seed`` on ``device``."""
    _family(cfg, "dlrm")
    dev = resolve_device(device)
    return DL.make_batch(cfg, shape,
                         torch.Generator(device=dev).manual_seed(seed))


def prefill(cfg: ModelConfig, p, batch, *, max_len: Optional[int] = None):
    """-> (last-position logits (B, V) f32, cache of ``max_len`` rows); a
    whisper batch holds ``frames`` and ``tokens``, a VLM's ``patches`` and
    ``tokens``."""
    _family(cfg, *TF.SERVE_FAMILIES, "audio")
    if cfg.family == "audio":
        return WH.prefill(cfg, p, batch, max_len=max_len)
    return TF.prefill(cfg, p, batch, max_len=max_len)


def decode_step(cfg: ModelConfig, p, cache, tokens):
    """Whisper's one-token step over its shared-position cache (the legacy
    serve path, ``whisper.decode_step``).  The decoder families decode
    through `decode_n` (``transformer.decode_step_paged``); the reference's
    shared-position ``transformer.decode_step`` waits for ROADMAP.md
    queue 1, item 5."""
    if cfg.family != "audio":
        _family(cfg, *_MODELS)
        raise NotImplementedError(
            f"api.decode_step of the {cfg.family} family waits for "
            f"ROADMAP.md queue 1, item 5; decode through api.decode_n")
    return WH.decode_step(cfg, p, cache, tokens)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               enc_len: Optional[int] = None, device="cuda"):
    """Zeros of a decode cache; whisper's holds ``enc_len`` (default
    ``max_len``) cross rows beside its ``max_len`` self rows."""
    _family(cfg, *TF.SERVE_FAMILIES, "audio")
    dev = resolve_device(device)
    if cfg.family == "audio":
        return WH.init_cache(cfg, batch, max_len, enc_len or max_len,
                             device=dev)
    return TF.init_cache(cfg, batch, max_len, device=dev)


# -- serve fast path --------------------------------------------------------


def prefill_slot(cfg: ModelConfig, p, batch, cache, slot, *,
                 max_len: Optional[int] = None):
    """Prefill newly admitted request(s) and write their KV rows (and SSD
    states and conv histories) into batch rows ``slot`` of the live
    ``cache`` (in place); rows whose slot index is out of range are padding
    and are dropped.
    Returns (last_logits (n, V), cache)."""
    if cfg.family == "audio":
        raise NotImplementedError(
            "incremental admission is transformer-cache only; serve whisper "
            "through the legacy full-batch path")
    _family(cfg)
    logits, slot_cache = TF.prefill(cfg, p, batch, max_len=max_len)
    return logits, TF.cache_insert(cache, slot_cache, slot)


def cache_insert(cache, slot_cache, slot):
    return TF.cache_insert(cache, slot_cache, slot)


def decode_n(cfg: ModelConfig, p, cache, tokens, seq_lens, budget, *,
             num_steps: int, **kw):
    """Multi-step decode with per-slot lengths/budgets; see
    transformer.decode_n.  Pass ``tables=(B, nb)`` to decode over a pooled
    prefix-shared KV cache (`init_kv_pool`) instead of per-slot rows."""
    if cfg.family == "audio":
        raise NotImplementedError(
            "decode_n is transformer-cache only; serve whisper through the "
            "legacy per-token path")
    _family(cfg)
    return TF.decode_n(cfg, p, cache, tokens, seq_lens, budget,
                       num_steps=num_steps, **kw)


# -- pooled prefix-shared KV (block tables) ----------------------------------


def init_kv_pool(cfg: ModelConfig, num_blocks: int, block_size: int, *,
                 device="cuda"):
    """Pooled bf16 KV cache (L, NB, bs, KH, hd) on ``device``; dense
    attention families only; see transformer.init_kv_pool."""
    _family(cfg, "dense")
    return TF.init_kv_pool(cfg, num_blocks, block_size,
                           device=resolve_device(device))


def prefill_suffix(cfg: ModelConfig, p, cache, tokens, start, valid, tables):
    """Fixed-width suffix prefill over a pooled KV cache: rows resume at
    logical position ``start`` with ``valid`` fresh tokens, KV lands in the
    blocks named by ``tables`` (in place); see transformer.prefill_suffix.
    Returns (logits (B, V) at each row's last valid position, cache)."""
    _family(cfg, "dense")
    return TF.prefill_suffix(cfg, p, cache, tokens, start, valid, tables)
