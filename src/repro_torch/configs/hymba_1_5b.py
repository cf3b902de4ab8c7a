"""hymba-1.5b [hybrid] — 32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001.

Parallel attention + mamba heads within each layer; sliding-window attention
on most layers with a few global layers; ssm_state=16.  Layer l is global
when ``l % global_every == global_every - 1`` (``transformer.
window_schedule``): layers 15 and 31 at full width. [arXiv:2411.13676; hf]
"""
from repro_torch.configs.base import AttentionConfig, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    num_layers=32,
    d_model=1600,
    d_ff=5504,
    vocab_size=32001,
    attention=AttentionConfig(
        num_heads=25,
        num_kv_heads=5,
        head_dim=64,
        sliding_window=1024,
        global_every=16,
        rope_theta=10000.0,
    ),
    ssm=SSMConfig(
        state_dim=16,
        head_dim=64,
        expand=2,                # d_inner = 3200 -> 50 SSM heads
        chunk=256,
        conv_width=4,
    ),
    parallel_heads=True,
    norm="rmsnorm",
    act="silu",
    ffn_glu=True,
    max_seq_len=8192,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        num_layers=3,
        d_model=64,
        d_ff=128,
        vocab_size=512,
        attention=AttentionConfig(
            num_heads=4, num_kv_heads=2, head_dim=16,
            sliding_window=16, global_every=2),
        ssm=SSMConfig(state_dim=8, head_dim=16, expand=2, chunk=16, conv_width=4),
        max_seq_len=128,
    )
