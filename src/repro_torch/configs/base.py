"""Config dataclasses of the port's families (dense, MoE, SSM, hybrid,
audio, VLM and DLRM).

Copies of ``repro.configs.base.ShapeConfig``, ``AttentionConfig``,
``MoEConfig``, ``SSMConfig``, ``EmbeddingTableConfig``, ``DLRMConfig`` and
``ModelConfig``, the last cut to the fields the port's models read
(whisper's encoder fields and a VLM's vision prefix among them), and of
the run-level ``ParallelConfig``, ``OptimizerConfig`` and ``RunConfig``,
whole.  The port keeps its own copy instead of importing the JAX package;
``tests/test_torch_interop.py`` holds every kept field equal to the
reference config.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


# kind: which step function the cell drives.
#   "train"   -> forward + backward + optimizer update
#   "prefill" -> forward over the full sequence (for a DLRM: scoring)
#   "decode"  -> one new token against a seq_len KV cache/state
@dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str                 # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int

    def __post_init__(self):
        assert self.kind in ("train", "prefill", "decode"), self.kind


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
class MoEConfig:
    num_experts: int
    top_k: int
    expert_ffw: int                    # per-expert FFN hidden dim
    num_shared_experts: int = 0        # kimi-k2 style shared expert(s)
    shared_ffw: int = 0
    router_softcap: Optional[float] = None
    # first `dense_layers` layers use a dense FFN instead of MoE (deepseek/kimi style)
    dense_layers: int = 0
    dense_ffw: int = 0


@dataclass(frozen=True)
class SSMConfig:
    state_dim: int                     # N (ssm_state)
    head_dim: int = 64                 # P per SSD head
    num_heads: int = 0                 # 0 -> derive: d_inner // head_dim
    expand: int = 2                    # d_inner = expand * d_model
    chunk: int = 256                   # SSD chunk length
    conv_width: int = 4


@dataclass(frozen=True)
class EmbeddingTableConfig:
    name: str
    vocab_size: int
    dim: int
    # average number of categorical values per example (1 = univalent)
    avg_valency: float = 1.0
    max_valency: int = 1
    combiner: str = "sum"              # "sum" | "mean"

    def __post_init__(self):
        assert self.combiner in ("sum", "mean")


@dataclass(frozen=True)
class DLRMConfig:
    tables: Tuple[EmbeddingTableConfig, ...]
    # dense tower
    bottom_mlp: Tuple[int, ...] = (512, 256, 128)
    top_mlp: Tuple[int, ...] = (1024, 1024, 512, 256, 1)
    dense_features: int = 13
    interaction: str = "dot"           # "dot" | "cat"


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                        # "dense" | "moe" | "ssm" | "hybrid" |
                                       # "audio" | "vlm" | "dlrm"
    num_layers: int
    d_model: int
    d_ff: int
    vocab_size: int
    attention: Optional[AttentionConfig] = None
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    dlrm: Optional[DLRMConfig] = None

    norm: str = "rmsnorm"              # "rmsnorm" | "layernorm" | "nonparam_ln"
    act: str = "silu"                  # "silu" | "gelu" (glu applied per ffn_glu)
    ffn_glu: bool = True               # gated FFN (SwiGLU/GeGLU)
    tie_embeddings: bool = False
    final_logit_softcap: Optional[float] = None   # gemma2: 30.0
    post_norm: bool = False            # gemma2 post-layer norms
    embed_scale: bool = False          # gemma2 scales embeddings by sqrt(d_model)
    max_seq_len: int = 131072

    # encoder-decoder (whisper): encoder layer count; 0 = decoder-only
    encoder_layers: int = 0
    encoder_seq_reduction: int = 1     # conv frontend downsampling (stubbed)

    # vlm: number of prefix patch positions fed as stub embeddings
    vision_prefix: int = 0
    vision_dim: int = 0

    # hybrid: run attention and SSM in parallel per layer (hymba)
    parallel_heads: bool = False

    # numerics
    dtype: str = "bfloat16"
    param_dtype: str = "float32"

    @property
    def head_dim(self) -> int:
        assert self.attention is not None
        return self.attention.head_dim

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Run-level config (parallelism + training knobs), consumed by launch/*
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ParallelConfig:
    # axis names must match the mesh axes
    data_axis: str = "data"
    model_axis: str = "model"
    pod_axis: Optional[str] = None     # None on single-pod meshes
    fsdp: bool = True                  # shard params over data axis (ZeRO-3 style)
    zero1: bool = True                 # shard optimizer state over data axis
    tensor_parallel: bool = True       # shard heads/ffn/vocab over model axis
    expert_parallel: bool = True       # shard experts over model axis (MoE)
    sequence_parallel: bool = True     # shard long sequences / KV over model axis
    # Table 3 hyperparameter: activation/weight partitioning dimensionality
    activation_partition: str = "1d"   # "1d" | "2d"
    weight_partition: str = "1d"       # "1d" | "2d"
    pipeline_stages: int = 1           # >1 maps pipeline onto pod axis
    remat: str = "block"               # "none" | "block" | "full"
    grad_compression: str = "none"     # "none" | "int8" | "topk"
    overlap_decomposition: int = 1     # >1: split matmuls to overlap collectives
    use_sparse_embed: bool = True      # SparseCore-style vocab embedding path
    # compute the LM loss in sequence chunks so the (tokens x vocab) logits
    # tensor never materialises
    xent_chunk: int = 0                # 0 = off (materialise full logits)
    # cast FSDP-gathered weights to bf16 BEFORE the all-gather
    bf16_fsdp_gather: bool = False
    # attention implementation: "qchunked" scans only the reachable
    # (q-chunk, kv-chunk) pairs
    attn_impl: str = "blocked"         # "blocked" | "qchunked"
    # SparseCore embedding exchange knobs
    emb_wire_bf16: bool = False        # bf16 vectors on the ICI wire
    emb_capacity_factor: float = 2.0   # all-to-all send slot provisioning
    emb_method: str = "auto"           # "auto" | "a2a" | "psum"
    emb_pipeline: bool = True          # fused multi-group pipelined executor


@dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adam"                 # "adam" | "adafactor" | "sgd"
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: float = 1.0
    state_dtype: str = "float32"       # "bfloat16" for the 1T config
    warmup_steps: int = 100


@dataclass(frozen=True)
class RunConfig:
    model: ModelConfig
    shape: ShapeConfig
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    seed: int = 0

    def replace(self, **kw) -> "RunConfig":
        return dataclasses.replace(self, **kw)
