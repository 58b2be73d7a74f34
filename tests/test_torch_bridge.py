"""Weight and cache bridge between the JAX package and the PyTorch port:
the round trip JAX pytree -> port modules -> JAX pytree is bit-exact."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_family, reduced  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.configs import get_family as t_get_family  # noqa: E402
from repro_torch.configs import reduced as t_reduced  # noqa: E402


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _assert_same_tree(a, b):
    fa, ta = jax.tree.flatten(a)
    fb, tb = jax.tree.flatten(b)
    assert ta == tb
    for x, y in zip(fa, fb):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(_bits(x), _bits(y))


def _cfgs(dtype):
    jcfg = reduced(get_family("qwen3")["chat"])
    tcfg = t_reduced(t_get_family("qwen3")["chat"])
    return (dataclasses.replace(jcfg, dtype=dtype),
            dataclasses.replace(tcfg, dtype=dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_round_trip_bit_exact(dtype):
    jcfg, tcfg = _cfgs(dtype)
    params = jax.tree.map(np.asarray,
                          jlm.init_params(jax.random.PRNGKey(0), jcfg))
    model = bridge.params_to_torch(params, tcfg, device="cpu")
    assert len(model.blocks) == tcfg.num_layers
    assert model.embed.dtype == {"float32": torch.float32,
                                 "bfloat16": torch.bfloat16}[dtype]
    assert model.blocks[0].ln1["scale"].dtype == torch.float32
    _assert_same_tree(params, bridge.params_from_torch(model))


def test_untied_head_with_qkv_bias_round_trip():
    from repro.rag.stages import DRAFT_MODELS
    jcfg = reduced(DRAFT_MODELS["qwen1p5_0p5b"])
    tcfg = t_reduced(t_get_config("qwen1.5-0.5b"))
    params = jax.tree.map(np.asarray,
                          jlm.init_params(jax.random.PRNGKey(1), jcfg))
    assert "lm_head" in params and "bq" in params["blocks"]["attn"]
    model = bridge.params_to_torch(params, tcfg, device="cpu")
    assert model.lm_head is not None
    _assert_same_tree(params, bridge.params_from_torch(model))


def test_bf16_values_cross_unchanged():
    vals = np.random.default_rng(0).standard_normal(257).astype(np.float32)
    a = np.asarray(jnp.asarray(vals, jnp.bfloat16))
    t = bridge.to_torch(a, "cpu")
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), a.astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cache_round_trip_bit_exact(dtype):
    jcfg, tcfg = _cfgs(dtype)
    cache = jlm.init_cache(jcfg, batch=2, max_len=24)
    rng = np.random.default_rng(2)
    cache = {"idx": jnp.asarray(5, jnp.int32),
             "layers": {k: jnp.asarray(rng.standard_normal(v.shape),
                                       v.dtype)
                        for k, v in cache["layers"].items()}}
    cache = jax.tree.map(np.asarray, cache)
    tc = bridge.cache_to_torch(cache, device="cpu")
    assert tc["idx"] == 5
    assert tuple(tc["layers"]["k"].shape) == (tcfg.num_layers, 2, 24,
                                              tcfg.num_kv_heads,
                                              tcfg.resolved_head_dim)
    _assert_same_tree(cache, bridge.cache_from_torch(tc))
