"""Family-dispatching model API of the port (``repro/models/api.py``).

The dense family serves (prefill, decode); the DLRM family scores
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
    """Raise unless ``cfg.family`` is one of ``ok`` (default: dense)."""
    ok = ok or ("dense",)
    if cfg.family in ok:
        return
    if cfg.family == "audio":
        raise NotImplementedError(
            "whisper (legacy full-batch serve path) waits for ROADMAP.md "
            "queue 1, item 11")
    if cfg.family == "dlrm":
        raise NotImplementedError(
            "the DLRM scores through api.forward; it has no decoder")
    if cfg.family == "dense":
        raise NotImplementedError(
            "the dense family's training forward and batches wait for "
            "ROADMAP.md queue 1, items 5 and 7")
    raise NotImplementedError(
        f"family {cfg.family!r} waits for ROADMAP.md queue 1, item 11")


def init_params(cfg: ModelConfig, *, seed: int = 0, device="cuda",
                dtype: Optional[torch.dtype] = None):
    """Random params from a ``torch.Generator`` seeded with ``seed``, on
    ``device``, in the JAX layout.  ``dtype``: the dense family's weights
    (default bf16); a DLRM's params are f32, as the reference's.  (Weights
    that must equal the JAX package's come over through
    ``repro_torch.interop``.)"""
    _family(cfg, "dense", "dlrm")
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    if cfg.family == "dlrm":
        if dtype not in (None, torch.float32):
            raise ValueError(f"DLRM params are float32, not {dtype}")
        return DL.init_params(cfg, gen)
    return TF.init_params(cfg, gen, device=dev,
                          dtype=dtype or torch.bfloat16)


def forward(cfg: ModelConfig, p, batch, **kw):
    """DLRM: -> (logits (B,) f32, aux 0.0); ``fused=`` picks the lookup
    route (see ``models/dlrm.forward``)."""
    _family(cfg, "dlrm")
    return DL.forward(cfg, p, batch, **kw)


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
    """Prefill newly admitted request(s) and write their KV rows into batch
    rows ``slot`` of the live ``cache`` (in place); rows whose slot index
    is out of range are padding and are dropped.
    Returns (last_logits (n, V), cache)."""
    _family(cfg)
    logits, slot_cache = TF.prefill(cfg, p, batch, max_len=max_len)
    return logits, TF.cache_insert(cache, slot_cache, slot)


def cache_insert(cache, slot_cache, slot):
    return TF.cache_insert(cache, slot_cache, slot)


def decode_n(cfg: ModelConfig, p, cache, tokens, seq_lens, budget, *,
             num_steps: int, **kw):
    """Multi-step decode with per-slot lengths/budgets; see
    transformer.decode_n."""
    _family(cfg)
    return TF.decode_n(cfg, p, cache, tokens, seq_lens, budget,
                       num_steps=num_steps, **kw)
