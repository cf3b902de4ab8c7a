"""JAX params -> torch through numpy (``repro_torch.interop``), and the
port's config copies against the reference configs."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as JREG
from repro.models import api as JAPI
from repro_torch import interop
from repro_torch.configs import registry as TREG
from repro_torch.configs.base import AttentionConfig, DLRMConfig, ModelConfig


@pytest.fixture(scope="module")
def jax_tree():
    cfg = JREG.get_reduced("olmo-1b")
    return jax.tree.map(np.asarray,
                        JAPI.init_params(cfg, jax.random.PRNGKey(0)))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        if not tree:
            out[prefix] = "{}"
        return out
    return {prefix: tree}


def test_round_trip_keeps_layout_dtype_values(jax_tree):
    tp = interop.params_from_numpy(jax_tree)
    j, t = _leaves(jax_tree), _leaves(tp)
    assert j.keys() == t.keys()
    for path, a in j.items():
        b = t[path]
        if isinstance(a, str):                  # empty norm dict
            assert b == "{}", path
            continue
        assert isinstance(b, torch.Tensor) and b.device.type == "cpu"
        assert tuple(b.shape) == a.shape, path
        assert str(b.dtype).removeprefix("torch.") == str(a.dtype), path
        np.testing.assert_array_equal(b.numpy(), a, err_msg=path)


def test_layout_names_and_shapes(jax_tree):
    cfg = TREG.get_reduced("olmo-1b")
    a = cfg.attention
    L, d, f = cfg.num_layers, cfg.d_model, cfg.d_ff
    tp = interop.params_from_numpy(jax_tree)
    assert tp["final_norm"] == {} and tp["layers"]["ln1"] == {}
    attn, mlp = tp["layers"]["attn"], tp["layers"]["mlp"]
    assert attn["wq"].shape == (L, d, a.num_heads, a.head_dim)
    assert attn["wk"].shape == (L, d, a.num_kv_heads, a.head_dim)
    assert attn["wo"].shape == (L, a.num_heads * a.head_dim, d)
    assert mlp["wg"].shape == (L, d, f) and mlp["wo"].shape == (L, f, d)
    assert tp["embed"].shape == (cfg.vocab_size, d)


def test_bf16_cast_at_load_equals_jax_cast(jax_tree):
    import jax.numpy as jnp
    tp = interop.params_from_numpy(jax_tree, dtype=torch.bfloat16)
    w = jax_tree["layers"]["mlp"]["wg"]
    want = np.asarray(jnp.asarray(w).astype(jnp.bfloat16).astype(jnp.float32))
    got = tp["layers"]["mlp"]["wg"].float().numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("getter", ["get_config", "get_reduced"])
def test_config_copy_matches_reference(getter):
    """Every field the port keeps equals the JAX package's value."""
    t = getattr(TREG, getter)("olmo-1b")
    j = getattr(JREG, getter)("olmo-1b")
    for f in dataclasses.fields(ModelConfig):
        if f.name == "attention":
            continue
        assert getattr(t, f.name) == getattr(j, f.name), f.name
    for f in dataclasses.fields(AttentionConfig):
        assert getattr(t.attention, f.name) == getattr(j.attention, f.name)


def _dlrm_fields(cfg):
    """A DLRM config as plain values: ModelConfig fields, the tower, and
    every field of every table."""
    d = cfg.dlrm
    return (
        {f.name: getattr(cfg, f.name) for f in dataclasses.fields(ModelConfig)
         if f.name not in ("attention", "dlrm")},
        {f.name: getattr(d, f.name) for f in dataclasses.fields(DLRMConfig)
         if f.name != "tables"},
        [dataclasses.astuple(t) for t in d.tables])


@pytest.mark.parametrize("getter", ["get_config", "get_reduced"])
def test_dlrm0_copy_matches_reference(getter):
    """The port's dlrm0 (150 tables at full size) equals the reference
    config field by field, and so does the one-card cut's table list."""
    t = getattr(TREG, getter)("dlrm0")
    j = getattr(JREG, getter)("dlrm0")
    assert t.attention is None and j.attention is None
    assert _dlrm_fields(t) == _dlrm_fields(j)
    if getter == "get_config":
        assert len(t.dlrm.tables) == 150
        from repro.configs import dlrm0 as JD
        from repro_torch.configs import dlrm0 as TD
        assert ([dataclasses.astuple(x) for x in TD._table_specs(
                    target_params=12_000_000_000)]
                == [dataclasses.astuple(x) for x in JD._table_specs(
                    target_params=12_000_000_000)])


def test_params_from_numpy_turns_the_jax_dlrm_tree():
    """Lists (``bottom``/``top`` of {"w", "b"}) and tuples keep their
    nesting; every leaf keeps its values."""
    cfg = JREG.get_reduced("dlrm0")
    tree = jax.tree.map(np.asarray,
                        JAPI.init_params(cfg, jax.random.PRNGKey(0)))
    tp = interop.params_from_numpy(tree)
    assert isinstance(tp["bottom"], list) and isinstance(tp["top"], list)
    leaves_j = jax.tree.leaves(tree)
    leaves_t = jax.tree.leaves(tp)
    assert len(leaves_j) == len(leaves_t)
    for a, b in zip(leaves_j, leaves_t):
        np.testing.assert_array_equal(b.numpy(), a)
    pair = interop.params_from_numpy((tree["top"][0]["b"], [tree["top"][1]]))
    assert isinstance(pair, tuple) and isinstance(pair[1], list)


def test_unknown_arch_names_the_roadmap():
    """Every arch of the reference's registry is the port's, in its order;
    an arch that neither registry has raises ``KeyError`` naming the known
    ones."""
    assert TREG.ARCHS == JREG.ALL_ARCHS
    for reg in (TREG, JREG):
        with pytest.raises(KeyError, match="olmo-1b"):
            reg.get_config("no-such-arch")
    with pytest.raises(KeyError, match="no-such-arch"):
        TREG.get_reduced("no-such-arch")
