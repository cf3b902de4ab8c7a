"""Synthetic data pipeline (port of ``repro/data/synthetic.py``).

Deterministic, seekable, host-side generation, pure numpy, so that
``Dataset.batch(step)`` gives bitwise the reference's arrays:
  * LM token streams (zipf-ish unigram distribution over the vocab),
  * DLRM categorical features (power-law ids, per-table valency),
  * vision-patch stubs for a VLM prefix.

The audio branch needs ``models/whisper.split_seq``, which is not ported:
it raises, naming ROADMAP.md queue 1, item 11.

``Dataset.batch(step)`` is pure in (seed, step): any host can regenerate any
step, which is what makes checkpoint/restart and elastic rescaling exact.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

import numpy as np

from repro_torch.configs.base import ModelConfig, ShapeConfig


@dataclass
class Dataset:
    cfg: ModelConfig
    shape: ShapeConfig
    seed: int = 0

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng((self.seed * 1_000_003 + step) & 0x7FFFFFFF)

    def _zipf_tokens(self, rng, shape, vocab: int) -> np.ndarray:
        """Zipf-flavoured token ids in [0, vocab)."""
        u = rng.random(shape)
        ids = np.minimum((u ** 3.0) * vocab, vocab - 1)
        return ids.astype(np.int32)

    def batch(self, step: int) -> Dict[str, Any]:
        """The numpy arrays of batch ``step``."""
        cfg, shape = self.cfg, self.shape
        if cfg.family == "audio":
            raise NotImplementedError(
                "audio batches need models/whisper.split_seq, which waits "
                "for ROADMAP.md queue 1, item 11")
        rng = self._rng(step)
        B, T = shape.global_batch, shape.seq_len
        if cfg.family == "dlrm":
            return self._dlrm_batch(rng, B)
        t_text = T - (cfg.vision_prefix if cfg.family == "vlm" else 0)
        stream = self._zipf_tokens(rng, (B, t_text + 1), cfg.vocab_size)
        out = {"tokens": stream[:, :-1]}
        if cfg.family == "vlm":
            out["patches"] = rng.standard_normal(
                (B, cfg.vision_prefix, cfg.vision_dim)).astype(np.float32) * 0.1
        if shape.kind == "train":
            out["labels"] = stream[:, 1:]
        return out

    def _dlrm_batch(self, rng, B: int) -> Dict[str, Any]:
        cfg = self.cfg
        out: Dict[str, Any] = {
            "dense": rng.standard_normal(
                (B, cfg.dlrm.dense_features)).astype(np.float32),
            "labels": (rng.random(B) < 0.3).astype(np.int32),
        }
        for t in cfg.dlrm.tables:
            ids = self._zipf_tokens(rng, (B, t.max_valency), t.vocab_size)
            keep_p = min(1.0, t.avg_valency / max(t.max_valency, 1))
            live = rng.random((B, t.max_valency)) < keep_p
            live[:, 0] = True
            out[f"cat_{t.name}"] = np.where(live, ids, -1).astype(np.int32)
        return out
