"""kimi-k2-1t-a32b [moe] — 61L d_model=7168 64H (GQA kv=8) vocab=163840.

MoE with 384 experts, top-8, per-expert d_ff=2048, one shared expert, first
layer dense (paper-table trillion-parameter MoE). [arXiv:2501.kimi2]
"""
from repro_torch.configs.base import AttentionConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    num_layers=61,
    d_model=7168,
    d_ff=2048,                   # per-expert hidden dim
    vocab_size=163840,
    attention=AttentionConfig(
        num_heads=64,
        num_kv_heads=8,
        head_dim=128,
        rope_theta=50000.0,
    ),
    moe=MoEConfig(
        num_experts=384,
        top_k=8,
        expert_ffw=2048,
        num_shared_experts=1,
        shared_ffw=2048,
        dense_layers=1,
        dense_ffw=18432,
    ),
    norm="rmsnorm",
    act="silu",
    ffn_glu=True,
    max_seq_len=131072,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        num_layers=3,
        d_model=64,
        d_ff=32,
        vocab_size=512,
        attention=AttentionConfig(num_heads=4, num_kv_heads=2, head_dim=16),
        moe=MoEConfig(num_experts=8, top_k=2, expert_ffw=32,
                      num_shared_experts=1, shared_ffw=32,
                      dense_layers=1, dense_ffw=128),
        max_seq_len=128,
    )
