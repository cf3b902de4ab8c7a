"""whisper-small [audio] — 12L enc + 12L dec, d_model=768 12H d_ff=3072 vocab=51865.

Encoder-decoder; conv frontend is a STUB (input_specs provides precomputed frame
embeddings). [arXiv:2212.04356]
"""
from repro_torch.configs.base import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="audio",
    num_layers=12,               # decoder layers
    encoder_layers=12,
    encoder_seq_reduction=2,     # conv frontend stride (stubbed)
    d_model=768,
    d_ff=3072,
    vocab_size=51865,
    attention=AttentionConfig(
        num_heads=12,
        num_kv_heads=12,
        head_dim=64,
        rope_theta=10000.0,      # we use RoPE in place of learned positions (backbone only)
    ),
    norm="layernorm",
    act="gelu",
    ffn_glu=False,
    tie_embeddings=True,
    max_seq_len=448,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        num_layers=2,
        encoder_layers=2,
        d_model=64,
        d_ff=128,
        vocab_size=512,
        attention=AttentionConfig(num_heads=4, num_kv_heads=4, head_dim=16),
        max_seq_len=128,
    )
