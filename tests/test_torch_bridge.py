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


def _hybrid_cfgs(dtype):
    from repro.configs import get_config
    jcfg = reduced(get_config("zamba2-1.2b"), layers=7)
    tcfg = t_reduced(t_get_config("zamba2-1.2b"), layers=7)
    return (dataclasses.replace(jcfg, dtype=dtype),
            dataclasses.replace(tcfg, dtype=dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hybrid_params_round_trip_bit_exact(dtype):
    """Stacked ``blocks`` {ln, mamba} and the one unstacked ``shared``
    dense block cross both ways unchanged."""
    jcfg, tcfg = _hybrid_cfgs(dtype)
    params = jax.tree.map(np.asarray,
                          jlm.init_params(jax.random.PRNGKey(3), jcfg))
    assert params["blocks"]["mamba"]["wx"].shape[0] == 7
    model = bridge.params_to_torch(params, tcfg, device="cpu")
    assert len(model.blocks) == 7
    assert model.blocks[0].mamba["A_log"].dtype == torch.float32
    assert model.shared.attn["wq"].dtype == model.embed.dtype
    _assert_same_tree(params, bridge.params_from_torch(model))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hybrid_cache_round_trip_bit_exact(dtype):
    jcfg, tcfg = _hybrid_cfgs(dtype)
    cache = jlm.init_cache(jcfg, batch=2, max_len=24)
    rng = np.random.default_rng(4)
    cache = jax.tree.map(
        lambda v: np.asarray(jnp.asarray(rng.standard_normal(v.shape),
                                         v.dtype)), cache)
    cache["idx"] = np.asarray(9, np.int32)
    tc = bridge.cache_to_torch(cache, device="cpu")
    assert tc["idx"] == 9 and sorted(tc) == ["attn", "idx", "mamba"]
    assert tuple(tc["attn"]["k"].shape) == (1, 2, 24, tcfg.num_kv_heads,
                                            tcfg.resolved_head_dim)
    _assert_same_tree(cache, bridge.cache_from_torch(tc))


def _family_cfgs(arch, layers, dtype):
    from repro.configs import get_config
    jcfg = reduced(get_config(arch), layers=layers)
    tcfg = t_reduced(t_get_config(arch), layers=layers)
    return (dataclasses.replace(jcfg, dtype=dtype),
            dataclasses.replace(tcfg, dtype=dtype))


CROSS_FAMILIES = [("whisper-large-v3", 2), ("llama-3.2-vision-90b", 4)]


@pytest.mark.parametrize("arch,layers", CROSS_FAMILIES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_family_params_round_trip_bit_exact(arch, layers, dtype):
    """vlm ``groups`` (cross blocks stacked on the group axis, ``selfs``
    stacked again inside each group) and audio ``encoder`` + decoder
    ``blocks``, each cross block with ``ln_x``, ``xattn`` and the f32
    scalar ``xgate``, cross both ways unchanged."""
    jcfg, tcfg = _family_cfgs(arch, layers, dtype)
    params = jax.tree.map(np.asarray,
                          jlm.init_params(jax.random.PRNGKey(5), jcfg))
    rng = np.random.default_rng(6)
    xg = params["groups"]["cross"] if "groups" in params else params["blocks"]
    xg["xgate"] = rng.standard_normal(xg["xgate"].shape).astype(np.float32)
    model = bridge.params_to_torch(params, tcfg, device="cpu")
    cross = (model.groups[1].cross if "groups" in params
             else model.blocks[1])
    assert cross.xgate.dtype == torch.float32 and cross.xgate.dim() == 0
    assert float(cross.xgate) == float(xg["xgate"][1])
    _assert_same_tree(params, bridge.params_from_torch(model))


@pytest.mark.parametrize("arch,layers,max_len", [
    ("zamba2-1.2b", 7, 40000),          # the 4096-slot ring with its pos
    ("whisper-large-v3", 2, 24), ("llama-3.2-vision-90b", 4, 24)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ring_and_cross_caches_round_trip_bit_exact(arch, layers, max_len,
                                                    dtype):
    jcfg, tcfg = _family_cfgs(arch, layers, dtype)
    cache = jlm.init_cache(jcfg, batch=2, max_len=max_len)
    rng = np.random.default_rng(7)
    cache = jax.tree.map(
        lambda v: np.asarray(jnp.asarray(
            rng.integers(-5000, 5000, v.shape) if v.dtype == jnp.int32
            else rng.standard_normal(v.shape), v.dtype)), cache)
    cache["idx"] = np.asarray(11, np.int32)
    tc = bridge.cache_to_torch(cache, device="cpu")
    assert tc["idx"] == 11
    if "attn" in tc:
        assert tc["attn"]["pos"].dtype == torch.int32
        assert tuple(tc["attn"]["pos"].shape) == (1, 4096)
    _assert_same_tree(cache, bridge.cache_from_torch(tc))


MOE_SSM = [("deepseek-v2-236b", 3), ("deepseek-v3-671b", 3),
           ("xlstm-350m", 4)]


@pytest.mark.parametrize("arch,layers", MOE_SSM)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_and_ssm_params_round_trip_bit_exact(arch, layers, dtype):
    """moe: stacked ``dense_blocks`` and ``moe_blocks`` (MLA with nested
    norm scales, the f32 ``router``, the ``shared`` experts) and v3's
    ``mtp``; ssm: the ``blocks_list`` of mLSTM (f32 ``wgate`` and
    ``gate_bias``) and sLSTM blocks; both ways unchanged."""
    jcfg, tcfg = _family_cfgs(arch, layers, dtype)
    params = jax.tree.map(np.asarray,
                          jlm.init_params(jax.random.PRNGKey(8), jcfg))
    model = bridge.params_to_torch(params, tcfg, device="cpu")
    if tcfg.family == "moe":
        assert len(model.dense_blocks) == 1 and len(model.moe_blocks) == 2
        assert model.moe_blocks[0].moe["router"].dtype == torch.float32
        assert model.dense_blocks[0].mla["q_norm"].dtype == torch.float32
        assert (model.mtp is not None) == (arch == "deepseek-v3-671b")
    else:
        assert [b.slstm is not None for b in model.blocks] == \
            [False, False, False, True]
        assert model.blocks[0].mlstm["wgate"].dtype == torch.float32
    _assert_same_tree(params, bridge.params_from_torch(model))


@pytest.mark.parametrize("arch,layers", MOE_SSM)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_and_ssm_caches_round_trip_bit_exact(arch, layers, dtype):
    """moe's ``ckv``/``krope`` become the column ranges of one ``latent``
    buffer and come back apart; ssm's mLSTM/sLSTM states cross as they
    are."""
    jcfg, tcfg = _family_cfgs(arch, layers, dtype)
    cache = jlm.init_cache(jcfg, batch=2, max_len=12)
    rng = np.random.default_rng(9)
    cache = jax.tree.map(lambda v: np.asarray(jnp.asarray(
        rng.standard_normal(v.shape), v.dtype)), cache)
    cache["idx"] = np.asarray(5, np.int32)
    tc = bridge.cache_to_torch(cache, device="cpu")
    assert tc["idx"] == 5
    if tcfg.family == "moe":
        lat = tc["layers"]["latent"]
        r = tcfg.mla.kv_lora_rank
        np.testing.assert_array_equal(
            _bits(bridge.to_numpy(lat[..., :r])),
            _bits(cache["layers"]["ckv"]))
        with pytest.raises(ValueError, match="needs its cfg"):
            bridge.cache_from_torch(tc)
    _assert_same_tree(cache, bridge.cache_from_torch(tc, tcfg))
