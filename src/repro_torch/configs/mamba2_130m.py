"""mamba2-130m [ssm] — 24L d_model=768 (attention-free) vocab=50280 ssm_state=128.

SSD (state-space duality), chunked scan. [arXiv:2405.21060]
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    num_layers=24,
    d_model=768,
    d_ff=0,                      # attention-free, no FFN: the SSD block is the mixer
    vocab_size=50280,
    ssm=SSMConfig(
        state_dim=128,
        head_dim=64,             # d_inner = 1536 -> 24 SSD heads
        expand=2,
        chunk=256,
        conv_width=4,
    ),
    norm="rmsnorm",
    act="silu",
    ffn_glu=False,
    tie_embeddings=True,
    max_seq_len=1_048_576,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        num_layers=3,
        d_model=64,
        vocab_size=512,
        ssm=SSMConfig(state_dim=16, head_dim=16, expand=2, chunk=16, conv_width=4),
        max_seq_len=2048,
    )
