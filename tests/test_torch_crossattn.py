"""The audio (whisper-large-v3) and vlm (llama-3.2-vision-90b) families of
the port against ``repro.models.lm`` on bridged weights, reduced (f32):
whisper to 2 encoder and 2 decoder layers over 16 source frames,
llama-3.2-vision to 4 layers (two groups of one cross block and one self
block) over 8 patch embeddings.

``xgate`` starts at 0 and ``tanh(0)`` would multiply every cross-attention
away, so each test first sets it to 0.5 in the JAX params, then bridges
them, and checks that zeroing the source changes the logits (the cross
path is live).

The train-mode forward with the source matches the reference to 1e-4;
prefill (which stores the source's cross k/v) and greedy decode (which
reads them) match its logits to 1e-3 (``tests/test_models.py``'s
tolerance) with equal greedy ids; the stored cross k/v match to 1e-4."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config, reduced  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.configs import reduced as t_reduced  # noqa: E402
from repro_torch.models import build_model as t_build  # noqa: E402

# arch -> (layers, the batch key of its source, where xgate lives)
FAMILIES = {"whisper-large-v3": (2, "audio_frames", ("blocks",)),
            "llama-3.2-vision-90b": (4, "vision_embeds", ("groups", "cross"))}


def _source_shape(cfg, b):
    if cfg.family == "audio":
        return (b, cfg.encdec.source_positions, cfg.d_model)
    return (b, cfg.vlm.vision_tokens, cfg.vlm.vision_dim)


def _models(arch):
    layers, key, where = FAMILIES[arch]
    jcfg = reduced(get_config(arch), layers=layers)
    tcfg = t_reduced(t_get_config(arch), layers=layers)
    jm, tm = j_build(jcfg), t_build(tcfg, "cpu")
    jp = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(3)))
    node = jp
    for k in where:
        node = node[k]
    node["xgate"] = np.full(node["xgate"].shape, 0.5, np.float32)
    tp = bridge.params_to_torch(jp, tcfg, "cpu")
    return jm, tm, jax.tree.map(jnp.asarray, jp), tp, tcfg, key


def _close(t, j, atol):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=atol, rtol=0)


@pytest.mark.parametrize("arch", sorted(FAMILIES))
def test_forward_prefill_decode_match_the_reference(arch):
    jm, tm, jp, tp, cfg, key = _models(arch)
    B, P, steps = 2, 12, 6
    rng = np.random.default_rng(4)
    toks = rng.integers(3, cfg.vocab_size, (B, P))
    src = rng.standard_normal(_source_shape(cfg, B)).astype(np.float32)
    jt, tt = jnp.asarray(toks, jnp.int32), torch.from_numpy(toks)
    jfull, _, _ = jm.apply(jp, {"tokens": jt, key: jnp.asarray(src)})
    tfull, _, _ = tm.apply(tp, {"tokens": tt, key: torch.from_numpy(src)})
    _close(tfull, jfull, 1e-4)
    zero, _, _ = tm.apply(tp, {"tokens": tt,
                               key: torch.zeros(_source_shape(cfg, B))})
    assert float((zero - tfull).abs().max()) > 1e-2, "cross path is dead"

    j_prefill, j_decode = jax.jit(jm.prefill), jax.jit(jm.decode_step)
    jc, tc = jm.init_cache(B, P + steps), tm.init_cache(B, P + steps)
    jl, jc = j_prefill(jp, {"tokens": jt, key: jnp.asarray(src)}, jc)
    tl, tc = tm.prefill(tp, {"tokens": tt, key: torch.from_numpy(src)}, tc)
    _close(tl, jl, 1e-3)
    for leaf in ("k", "v"):
        assert tuple(tc["cross_kv"][leaf].shape) == jc["cross_kv"][leaf].shape
        _close(tc["cross_kv"][leaf], jc["cross_kv"][leaf], 1e-4)
    j_ids = np.argmax(np.asarray(jl[:, -1]), -1)
    t_ids = torch.argmax(tl[:, -1], -1)
    assert t_ids.tolist() == j_ids.tolist()
    for _ in range(steps):
        jl, jc = j_decode(jp, jnp.asarray(j_ids[:, None], jnp.int32), jc)
        tl, tc = tm.decode_step(tp, t_ids[:, None], tc)
        _close(tl, jl, 1e-3)
        j_ids = np.argmax(np.asarray(jl), -1)
        t_ids = torch.argmax(tl, -1)
        assert t_ids.tolist() == j_ids.tolist()
    assert tc["idx"] == P + steps
    for group in tc:
        if group != "idx":
            for leaf, v in tc[group].items():
                _close(v, jc[group][leaf], 1e-3)
