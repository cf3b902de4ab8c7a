"""gemma2-9b [dense] — 42L d_model=3584 16H (GQA kv=8) d_ff=14336 vocab=256000.

Local+global alternating attention, logit softcapping. [arXiv:2408.00118; hf]
"""
from repro_torch.configs.base import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b",
    family="dense",
    num_layers=42,
    d_model=3584,
    d_ff=14336,
    vocab_size=256000,
    attention=AttentionConfig(
        num_heads=16,
        num_kv_heads=8,
        head_dim=256,
        logit_softcap=50.0,
        sliding_window=4096,
        global_every=2,          # every 2nd layer is global, others local
        rope_theta=10000.0,
        attn_scale=256 ** -0.5,
    ),
    norm="rmsnorm",
    act="gelu",
    ffn_glu=True,
    tie_embeddings=True,
    final_logit_softcap=30.0,
    post_norm=True,
    embed_scale=True,
    max_seq_len=8192,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        num_layers=4,
        d_model=64,
        d_ff=128,
        vocab_size=512,
        attention=AttentionConfig(
            num_heads=4, num_kv_heads=2, head_dim=16,
            logit_softcap=50.0, sliding_window=16, global_every=2,
            attn_scale=16 ** -0.5,
        ),
        max_seq_len=128,
    )
