"""qwen2-7b [dense] — 28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064.

GQA with QKV bias. [arXiv:2407.10671; hf]
"""
from repro_torch.configs.base import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="qwen2-7b",
    family="dense",
    num_layers=28,
    d_model=3584,
    d_ff=18944,
    vocab_size=152064,
    attention=AttentionConfig(
        num_heads=28,
        num_kv_heads=4,
        head_dim=128,
        qkv_bias=True,
        rope_theta=1_000_000.0,
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
        d_ff=160,
        vocab_size=512,
        attention=AttentionConfig(
            num_heads=4, num_kv_heads=2, head_dim=16, qkv_bias=True),
        max_seq_len=128,
    )
