"""Config dataclasses the port's dense family needs.

Copies of ``repro.configs.base.AttentionConfig`` and ``ModelConfig``,
cut to the fields a dense decoder reads.  The port keeps its own copy
instead of importing the JAX package; ``tests/test_torch_interop.py``
holds every kept field equal to the reference config.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class AttentionConfig:
    num_heads: int
    num_kv_heads: int
    head_dim: int
    qkv_bias: bool = False            # qwen2
    logit_softcap: Optional[float] = None   # gemma2: 50.0
    # Sliding-window pattern: window size for local layers; None = all global.
    sliding_window: Optional[int] = None
    # every `global_every`-th layer is global; others local (gemma2: 2).
    # 0 means all layers global.
    global_every: int = 0
    rope_theta: float = 10000.0
    # attention logit scale override; None -> 1/sqrt(head_dim)
    attn_scale: Optional[float] = None


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                        # "dense" (others: not ported yet)
    num_layers: int
    d_model: int
    d_ff: int
    vocab_size: int
    attention: Optional[AttentionConfig] = None

    norm: str = "rmsnorm"              # "rmsnorm" | "layernorm" | "nonparam_ln"
    act: str = "silu"                  # "silu" | "gelu" (glu applied per ffn_glu)
    ffn_glu: bool = True               # gated FFN (SwiGLU/GeGLU)
    tie_embeddings: bool = False
    final_logit_softcap: Optional[float] = None   # gemma2: 30.0
    post_norm: bool = False            # gemma2 post-layer norms
    embed_scale: bool = False          # gemma2 scales embeddings by sqrt(d_model)
    max_seq_len: int = 131072

    # vlm: number of prefix patch positions fed as stub embeddings
    vision_prefix: int = 0
    vision_dim: int = 0

    # numerics
    dtype: str = "bfloat16"
    param_dtype: str = "float32"

    @property
    def head_dim(self) -> int:
        assert self.attention is not None
        return self.attention.head_dim

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)
