"""internvl2-2b [vlm] — 24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92553.

InternViT + InternLM2 backbone; the ViT frontend is a STUB (input_specs provides
precomputed patch embeddings prepended to the token stream). [arXiv:2404.16821; hf]
"""
from repro_torch.configs.base import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b",
    family="vlm",
    num_layers=24,
    d_model=2048,
    d_ff=8192,
    vocab_size=92553,
    attention=AttentionConfig(
        num_heads=16,
        num_kv_heads=8,
        head_dim=128,
        rope_theta=1_000_000.0,
    ),
    vision_prefix=1024,          # stub patch positions per example
    vision_dim=1024,             # InternViT-300M hidden size (projected to d_model)
    norm="rmsnorm",
    act="silu",
    ffn_glu=True,
    max_seq_len=32768,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        num_layers=3,
        d_model=64,
        d_ff=128,
        vocab_size=512,
        attention=AttentionConfig(num_heads=4, num_kv_heads=2, head_dim=16),
        vision_prefix=8,
        vision_dim=32,
        max_seq_len=128,
    )
