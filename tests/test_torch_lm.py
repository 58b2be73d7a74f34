"""The port's LMs against ``repro.models.lm`` on bridged weights: the
port of ``test_models.py::test_prefill_decode_matches_forward`` for the
qwen3 stage models and the qwen1.5-0.5b draft (dense), and for zamba2-1.2b
(hybrid) reduced to 7 layers, so that it has one group of 6 Mamba2
layers, the shared attention block and one tail layer (reduced, f32).

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

# (JAX config, port config), reduced
CONFIGS = {
    **{f"qwen3-{role}": (lambda r=role: reduced(get_family("qwen3")[r]),
                         lambda r=role: t_reduced(t_get_family("qwen3")[r]))
       for role in ("embed", "rerank", "search", "chat")},
    "qwen1.5-0.5b": (lambda: reduced(get_config("qwen1.5-0.5b")),
                     lambda: t_reduced(t_get_config("qwen1.5-0.5b"))),
    # 7 layers: a group of 6 Mamba2 layers, the shared block, one tail layer
    "zamba2-1.2b": (lambda: reduced(get_config("zamba2-1.2b"), layers=7),
                    lambda: t_reduced(t_get_config("zamba2-1.2b"), layers=7)),
}


def _close(t, j, atol):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=atol, rtol=0)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_prefill_decode_matches_forward_and_jax(name):
    jcfg, tcfg = (f() for f in CONFIGS[name])
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
    tc = bridge.cache_from_torch(tcache)
    for group, leaves in tc.items():
        if group != "idx":
            for leaf, v in leaves.items():
                _close(torch.from_numpy(v), jcache[group][leaf], 1e-4)


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


def test_hybrid_cache_layout_and_unported_paths():
    """The hybrid cache stacks the Mamba2 states on a layer axis and holds
    one K/V slice per shared-block application; above 32768 positions it
    is a 4096-slot ring whose ``pos`` starts at ``NEG_POS``; every family
    is ported, so no architecture raises "not ported"."""
    from repro_torch.models import lm as tlm
    cfg = t_reduced(t_get_config("zamba2-1.2b"), layers=7)
    c = t_build(cfg, "cpu").init_cache(2, 48)
    di, K = cfg.ssm.expand * cfg.d_model, cfg.ssm.conv_kernel
    H = di // cfg.ssm.head_dim
    assert tuple(c["mamba"]["ssm"].shape) == (7, 2, H, cfg.ssm.head_dim,
                                              cfg.ssm.state_size)
    assert tuple(c["mamba"]["conv_x"].shape) == (7, 2, K - 1, di)
    assert tuple(c["attn"]["k"].shape) == (1, 2, 48, cfg.num_kv_heads,
                                           cfg.resolved_head_dim)
    ring = tlm.init_cache(cfg, 2, 40000, torch.device("cpu"))["attn"]
    for leaf in ("k", "v"):
        assert tuple(ring[leaf].shape) == (1, 2, 4096, cfg.num_kv_heads,
                                           cfg.resolved_head_dim)
    assert tuple(ring["pos"].shape) == (1, 4096)
    assert ring["pos"].dtype == torch.int32
    assert bool((ring["pos"] == tlm.NEG_POS).all())
    from repro_torch.configs import list_archs
    assert set(tlm.PORTED_FAMILIES) == {"dense", "hybrid", "vlm", "audio",
                                        "moe", "ssm"}
    for arch in list_archs():
        cfg = t_get_config(arch)
        tlm.require_ported(cfg)
        t_build(t_reduced(cfg), "cpu")


@pytest.mark.parametrize("arch,layers", [("deepseek-v2-236b", 3),
                                         ("deepseek-v3-671b", 3),
                                         ("xlstm-350m", 4)])
def test_moe_and_ssm_cache_layouts(arch, layers):
    """moe: one latent row per position, ``kv_lora_rank + rope`` wide,
    stacked over every layer; ssm: the mLSTM states stacked over the
    mLSTM layers (f32 C, n, m; the conv window in the model dtype), the
    sLSTM states over the sLSTM layers, m starting at -1e30."""
    cfg = t_reduced(t_get_config(arch), layers=layers)
    c = t_build(cfg, "cpu").init_cache(2, 24)
    assert c["idx"] == 0
    if cfg.family == "moe":
        m = cfg.mla
        assert tuple(c["layers"]["latent"].shape) == (
            layers, 2, 24, m.kv_lora_rank + m.qk_rope_head_dim)
        return
    s, d = cfg.ssm, cfg.d_model
    H, P = s.expand * d // s.head_dim, s.head_dim
    assert tuple(c["mlstm"]["C"].shape) == (3, 2, H, P, P)
    assert tuple(c["mlstm"]["conv"].shape) == (3, 2, s.conv_kernel - 1,
                                               s.expand * d)
    assert tuple(c["slstm"]["h"].shape) == (1, 2, d)
    assert bool((c["mlstm"]["m"] == -1e30).all())
    assert bool((c["slstm"]["m"] == -1e30).all())


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "deepseek-v3-671b",
                                  "xlstm-350m"])
def test_new_families_init_apply_and_serve_at_default_reduction(arch):
    """``build_model(cfg, "cpu").init``, ``apply`` and ``ServingEngine``
    on ``reduced(get_config(arch))`` as it comes (2 layers): finite
    logits, a positive MoE aux loss (0 for xLSTM), every request done."""
    from repro_torch.serving import ServingEngine
    cfg = t_reduced(t_get_config(arch))
    model = t_build(cfg, "cpu")
    params = model.init(0)
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 9)))
    logits, aux, _ = model.apply(params, {"tokens": toks})
    assert logits.shape == (2, 9, cfg.vocab_size)
    assert bool(logits.isfinite().all())
    assert (float(aux) > 0) == (cfg.family == "moe")
    eng = ServingEngine(cfg, params, max_len=48, prefill_chunk=8,
                        token_group=3)
    for n in (3, 20):
        eng.submit(list(range(3, 3 + n)), max_new=5)
    done = eng.run_to_completion()
    assert sorted(len(r.prompt_ids) for r in done) == [3, 20]
    assert all(r.done and 1 <= len(r.generated) <= 5 for r in done)
