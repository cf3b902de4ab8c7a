"""qwen3-moe-30b-a3b [moe] — 48L d_model=2048 32H (GQA kv=4) vocab=151936.

128 experts, top-8, per-expert d_ff=768. [hf:Qwen/Qwen3-30B-A3B]
"""
from repro_torch.configs.base import AttentionConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    d_ff=768,                    # per-expert hidden dim
    vocab_size=151936,
    attention=AttentionConfig(
        num_heads=32,
        num_kv_heads=4,
        head_dim=128,
        rope_theta=1_000_000.0,
    ),
    moe=MoEConfig(
        num_experts=128,
        top_k=8,
        expert_ffw=768,
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
        moe=MoEConfig(num_experts=8, top_k=2, expert_ffw=32),
        max_seq_len=128,
    )
