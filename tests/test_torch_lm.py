"""The port's dense LM against ``repro.models.lm`` on bridged weights: the
port of ``test_models.py::test_prefill_decode_matches_forward`` for the
qwen3 stage models and the qwen1.5-0.5b draft (reduced, f32).

Logits of the full forward, the prefill and every decode step match the
JAX package's to 1e-4; within the port, prefill and decode match its own
full forward to 1e-3, the reference test's tolerance."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config, get_family, reduced  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.configs import get_family as t_get_family  # noqa: E402
from repro_torch.configs import reduced as t_reduced  # noqa: E402
from repro_torch.models import build_model as t_build  # noqa: E402

CONFIGS = {
    **{f"qwen3-{role}": (lambda r=role: get_family("qwen3")[r],
                         lambda r=role: t_get_family("qwen3")[r])
       for role in ("embed", "rerank", "search", "chat")},
    "qwen1.5-0.5b": (lambda: get_config("qwen1.5-0.5b"),
                     lambda: t_get_config("qwen1.5-0.5b")),
}


def _close(t, j, atol):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=atol, rtol=0)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_prefill_decode_matches_forward_and_jax(name):
    jcfg, tcfg = (reduced(f()) for f in CONFIGS[name])
    jmodel, tmodel = j_build(jcfg), t_build(tcfg, "cpu")
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = bridge.params_to_torch(jax.tree.map(np.asarray, jparams),
                                     tcfg, device="cpu")
    B, S, P = 2, 40, 32
    toks = np.random.default_rng(1).integers(0, tcfg.vocab_size, (B, S))
    jt, tt = jnp.asarray(toks, jnp.int32), torch.from_numpy(toks)

    jfull, _, _ = jmodel.apply(jparams, {"tokens": jt}, mode="train")
    tfull, _, _ = tmodel.apply(tparams, {"tokens": tt}, mode="train")
    assert tfull.shape == (B, S, tcfg.vocab_size)
    _close(tfull, jfull, 1e-4)

    jcache, tcache = jmodel.init_cache(B, S), tmodel.init_cache(B, S)
    jpre, jcache = jmodel.prefill(jparams, {"tokens": jt[:, :P]}, jcache)
    tpre, tcache = tmodel.prefill(tparams, {"tokens": tt[:, :P]}, tcache)
    _close(tpre, jpre, 1e-4)
    assert float((tpre[:, P - 1] - tfull[:, P - 1]).abs().max()) < 1e-3
    assert tcache["idx"] == P
    for t in range(P, S):
        jlg, jcache = jmodel.decode_step(jparams, jt[:, t:t + 1], jcache)
        tlg, tcache = tmodel.decode_step(tparams, tt[:, t:t + 1], tcache)
        _close(tlg, jlg, 1e-4)
        assert float((tlg - tfull[:, t]).abs().max()) < 1e-3
    assert tcache["idx"] == S
    _close(tcache["layers"]["k"], jcache["layers"]["k"], 1e-4)


def test_init_params_follows_the_reference_distributions():
    """The port draws its own weights (not JAX's bits) from the same
    distributions: truncated normal on [-2, 2] times fan_in**-0.5, wo times
    (h*e)**-0.5, unit-scale embeddings, unit norm scales, zero biases."""
    cfg = t_reduced(t_get_config("qwen1.5-0.5b"))
    cfg = dataclasses.replace(cfg, d_model=256, num_heads=8, num_kv_heads=8,
                              head_dim=32, d_ff=512, vocab_size=4096)
    m = t_build(cfg, "cpu").init(0)
    b0 = m.blocks[0]
    std_tn = 0.8796    # std of a standard normal truncated to [-2, 2]
    for w, fan in ((b0.attn["wq"], 256), (b0.mlp["w_up"], 256),
                   (b0.mlp["w_down"], 512), (b0.attn["wo"], 8 * 32),
                   (m.embed, 1)):
        z = w.float() * fan ** 0.5
        assert float(z.abs().max()) <= 2.0
        assert abs(float(z.std()) - std_tn) < 0.02
    assert float(b0.attn["bq"].abs().max()) == 0.0
    assert torch.equal(b0.ln1["scale"], torch.ones(256))
    assert m.lm_head is not None and m.lm_head.shape == (256, 4096)
    # same seed, same weights
    assert torch.equal(t_build(cfg, "cpu").init(0).blocks[0].attn["wq"],
                       b0.attn["wq"])
