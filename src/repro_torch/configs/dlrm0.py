"""dlrm0 — the paper's own production recommendation workload (Figs 8-10, 17).

From the paper: "a DLRM with ~100M dense parameters in fully connected layers,
~20B embedding parameters (~300 features mapped to ~150 tables), and 1-100
average valency per feature" (Fig 8 caption).  Table specs are generated
deterministically with a Zipf-flavoured size distribution so that the totals hit
the paper's numbers: ~150 tables, ~20B embedding parameters, valency 1-100.

A copy of ``repro.configs.dlrm0`` (the port imports nothing of the JAX
package).  At 20e9 f32 parameters the tables fill a whole 80 GB H100; the
one-card configuration cuts only the vocabularies, by passing
``target_params=12_000_000_000`` to `_table_specs` where it is used
(``chip_smoke.py``).
"""
from __future__ import annotations

from repro_torch.configs.base import DLRMConfig, EmbeddingTableConfig, ModelConfig

NUM_TABLES = 150
TARGET_EMB_PARAMS = 20_000_000_000


def _table_specs(num_tables: int = NUM_TABLES,
                 target_params: int = TARGET_EMB_PARAMS):
    """Deterministic Zipf-ish table size distribution summing to ~target_params."""
    dims = [32, 64, 96, 128, 192, 256]
    tables = []
    # Zipf weights over table index: a few huge tables, a long small tail —
    # matches production DLRMs (paper §3.3: O(10 MiB) .. O(100 GiB) per table).
    weights = [1.0 / (i + 1) ** 0.85 for i in range(num_tables)]
    wsum = sum(weights)
    for i in range(num_tables):
        dim = dims[(i * 7) % len(dims)]
        params_i = target_params * weights[i] / wsum
        vocab = max(1000, int(params_i / dim))
        # valency 1..100: small frequent tables get multivalent features
        if i % 3 == 0:
            avg_val, max_val = 1.0, 1        # univalent
        elif i % 3 == 1:
            avg_val, max_val = 10.0, 32
        else:
            avg_val, max_val = 100.0, 128
        tables.append(EmbeddingTableConfig(
            name=f"table_{i:03d}",
            vocab_size=vocab,
            dim=dim,
            avg_valency=avg_val,
            max_valency=max_val,
            combiner="sum" if i % 2 == 0 else "mean",
        ))
    return tuple(tables)


def _dense_tower():
    # ~100M dense parameters: sized via the top MLP over the interaction output.
    # bottom: 13 dense features -> 512 -> 512 -> 256
    # top: concat(emb dims sample + bottom) -> 4096 -> 4096 -> 2048 -> 1024 -> 1
    return dict(
        bottom_mlp=(512, 512, 256),
        top_mlp=(4096, 4096, 2048, 1024, 1),
        dense_features=13,
        interaction="cat",
    )


CONFIG = ModelConfig(
    name="dlrm0",
    family="dlrm",
    num_layers=0,
    d_model=256,
    d_ff=0,
    vocab_size=0,
    dlrm=DLRMConfig(tables=_table_specs(), **_dense_tower()),
    norm="layernorm",
    act="gelu",
    ffn_glu=False,
)


def reduced() -> ModelConfig:
    tables = tuple(
        EmbeddingTableConfig(
            name=f"table_{i}",
            vocab_size=64 + 32 * i,
            dim=8,
            avg_valency=[1.0, 4.0, 8.0][i % 3],
            max_valency=[1, 8, 16][i % 3],
            combiner="sum" if i % 2 == 0 else "mean",
        )
        for i in range(6)
    )
    return CONFIG.replace(
        d_model=32,
        dlrm=DLRMConfig(
            tables=tables,
            bottom_mlp=(32, 16),
            top_mlp=(64, 32, 1),
            dense_features=13,
            interaction="cat",
        ),
    )
