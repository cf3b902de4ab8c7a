"""mistral-nemo-12b [dense] — 40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072.

128k context. [hf:mistralai/Mistral-Nemo-Base-2407; hf]
"""
from repro_torch.configs.base import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="mistral-nemo-12b",
    family="dense",
    num_layers=40,
    d_model=5120,
    d_ff=14336,
    vocab_size=131072,
    attention=AttentionConfig(
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
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
        d_ff=128,
        vocab_size=512,
        attention=AttentionConfig(num_heads=4, num_kv_heads=2, head_dim=16),
        max_seq_len=128,
    )
