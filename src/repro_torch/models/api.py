"""Family-dispatching model API of the port (``repro/models/api.py``).

The dense, MoE, SSM (mamba2) and hybrid (hymba) families train
(`forward`, with the aux loss the MoE layers sum) and serve (prefill,
decode; only the dense family on the pooled KV cache, as in the
reference); the DLRM family scores and trains
(`init_params`, `forward`, `make_batch`).  Every other family, and every
entry point a family does not have yet, raises ``NotImplementedError``
naming its ROADMAP.md item.  Entry points that create tensors take
``device=`` and default to the card: without CUDA and without
``device="cpu"`` they raise instead of running on the CPU.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import dlrm as DL
from repro_torch.models import transformer as TF


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises for a CUDA device on a
    machine without one (the port never falls back to the CPU silently)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the CPU")
    return dev


def _family(cfg: ModelConfig, *ok: str) -> None:
    """Raise unless ``cfg.family`` is one of ``ok`` (default: the decoder
    families, dense, MoE, SSM and hybrid)."""
    ok = ok or TF.DECODER_FAMILIES
    if cfg.family in ok:
        return
    if cfg.family == "audio":
        raise NotImplementedError(
            "whisper (legacy full-batch serve path) waits for ROADMAP.md "
            "queue 1, item 11")
    if cfg.family == "dlrm":
        raise NotImplementedError(
            "the DLRM scores through api.forward; it has no decoder")
    if cfg.family in TF.DECODER_FAMILIES and ok == ("dlrm",):  # make_batch
        raise NotImplementedError(
            f"api.make_batch of the {cfg.family} family waits for ROADMAP.md "
            f"queue 1, item 5; training draws its batches from "
            f"data.synthetic.Dataset")
    if cfg.family in TF.DECODER_FAMILIES:
        raise NotImplementedError(
            "pooled prefix-shared KV is dense-transformer only")
    raise NotImplementedError(
        f"family {cfg.family!r} waits for ROADMAP.md queue 1, item 11")


def init_params(cfg: ModelConfig, *, seed: int = 0, device="cuda",
                dtype: Optional[torch.dtype] = None):
    """Random params from a ``torch.Generator`` seeded with ``seed``, on
    ``device``, in the JAX layout.  ``dtype``: a decoder's weights
    (default bf16 for serving; ``torch.float32`` for training, the
    reference's f32 master weights, cast to bf16 at each use); a DLRM's
    params are f32, as the reference's.  ``device="meta"`` gives the
    shapes and dtypes only (`param_shapes`).  (Weights that must equal the
    JAX package's come over through ``repro_torch.interop``.)"""
    _family(cfg, *TF.DECODER_FAMILIES, "dlrm")
    dev = resolve_device(device)
    # a meta tensor draws nothing: any generator will do
    gen = torch.Generator(device="cpu" if dev.type == "meta" else dev)
    gen.manual_seed(seed)
    if cfg.family == "dlrm":
        if dtype not in (None, torch.float32):
            raise ValueError(f"DLRM params are float32, not {dtype}")
        return DL.init_params(cfg, gen, device=dev)
    return TF.init_params(cfg, gen, device=dev,
                          dtype=dtype or torch.bfloat16)


def param_shapes(cfg: ModelConfig, dtype: Optional[torch.dtype] = None):
    """`init_params`'s tree as ``meta`` tensors: shapes and dtypes, no
    storage (what ``train.checkpoint.restore`` reads a checkpoint into)."""
    return init_params(cfg, device="meta", dtype=dtype)


def forward(cfg: ModelConfig, p, batch, **kw):
    """Dense, MoE, SSM, hybrid: -> (logits (B, T, V) f32, aux: the MoE
    load-balance losses summed, 0.0 for the others); ``remat=``,
    ``kv_chunk=``, ``return_hidden=`` and ``attn_impl=`` as
    ``transformer.forward``.  DLRM: -> (logits (B,) f32, aux 0.0);
    ``fused=`` picks the lookup route (see ``models/dlrm.forward``)."""
    _family(cfg, *TF.DECODER_FAMILIES, "dlrm")
    if cfg.family == "dlrm":
        return DL.forward(cfg, p, batch, **kw)
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
    _family(cfg)
    return TF.prefill(cfg, p, batch, max_len=max_len)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, device="cuda"):
    _family(cfg)
    return TF.init_cache(cfg, batch, max_len, device=resolve_device(device))


# -- serve fast path --------------------------------------------------------


def prefill_slot(cfg: ModelConfig, p, batch, cache, slot, *,
                 max_len: Optional[int] = None):
    """Prefill newly admitted request(s) and write their KV rows (and SSD
    states and conv histories) into batch rows ``slot`` of the live
    ``cache`` (in place); rows whose slot index is out of range are padding
    and are dropped.
    Returns (last_logits (n, V), cache)."""
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
