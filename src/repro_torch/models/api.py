"""Family-dispatching model API of the port (``repro/models/api.py``).

Dense family only for now; every other family raises
``NotImplementedError`` naming its ROADMAP.md item.  Entry points that
create tensors take ``device=`` and default to the card: without CUDA and
without ``device="cpu"`` they raise instead of running on the CPU.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
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


def _family(cfg: ModelConfig) -> None:
    if cfg.family == "audio":
        raise NotImplementedError(
            "whisper (legacy full-batch serve path) waits for ROADMAP.md "
            "queue 1, item 11")
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} waits for ROADMAP.md queue 1, item 11")


def init_params(cfg: ModelConfig, *, seed: int = 0, device="cuda",
                dtype=torch.bfloat16):
    """Random params from a ``torch.Generator`` seeded with ``seed``, on
    ``device``, in the JAX layout.  (Weights that must equal the JAX
    package's come over through ``repro_torch.interop``.)"""
    _family(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return TF.init_params(cfg, gen, device=dev, dtype=dtype)


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
