"""olmo-1b [dense] — 16L d_model=2048 16H (GQA kv=16) d_ff=8192 vocab=50304.

Non-parametric LayerNorm. [arXiv:2402.00838; hf]
"""
from repro_torch.configs.base import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="olmo-1b",
    family="dense",
    num_layers=16,
    d_model=2048,
    d_ff=8192,
    vocab_size=50304,
    attention=AttentionConfig(
        num_heads=16,
        num_kv_heads=16,
        head_dim=128,
        rope_theta=10000.0,
    ),
    norm="nonparam_ln",
    act="silu",
    ffn_glu=True,
    tie_embeddings=True,
    max_seq_len=2048,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        num_layers=3,
        d_model=64,
        d_ff=128,
        vocab_size=512,
        attention=AttentionConfig(num_heads=4, num_kv_heads=4, head_dim=16),
        max_seq_len=128,
    )
