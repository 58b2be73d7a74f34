"""The moe family (DeepSeek: MLA attention + MoE FFN) of the port against
``repro.models`` on bridged weights, in f32.

``mla_attention`` in its naive form (no cache: MHA over per-head K/V)
and its absorbed form (a chunk written at an offset into the latent
cache, then a single token) matches the reference within 2e-5 (atol and
rtol: the kernel sweep's f32 tolerance), as does ``moe_ffn`` where a
small capacity factor and a biased router drop assignments: the same
assignments are dropped, in the reference's (token, choice) order, and
the aux loss is the same.  Reduced deepseek-v2 and -v3: the train forward, a prefill and
decode steps match the reference's logits within 1e-3 with equal greedy
ids, and the port's own prefill + decode match its no-cache forward
within 1e-3 (``tests/test_models.py``'s tolerances)."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config, reduced  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.models import mla as j_mla  # noqa: E402
from repro.models import moe as j_moe  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.configs import reduced as t_reduced  # noqa: E402
from repro_torch.models import build_model as t_build  # noqa: E402
from repro_torch.models import mla as t_mla  # noqa: E402
from repro_torch.models import moe as t_moe  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402

ARCHS = ("deepseek-v2-236b", "deepseek-v3-671b")


def _close(t, j, atol):
    """|t - j| <= atol (+ atol·|j| at the f32 kernel tolerance 2e-5, as
    ``tests/test_kernels.py`` takes it)."""
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=atol,
                               rtol=atol if atol <= 2e-5 else 0)


def _cfgs(arch, layers=3):
    """(JAX, port) reduced configs: one dense block, then MoE blocks."""
    return (reduced(get_config(arch), layers=layers),
            t_reduced(t_get_config(arch), layers=layers))


def _flat_torch(tree):
    return {k: bridge.to_torch(v, "cpu")
            for k, v in bridge._flat(jax.tree.map(np.asarray, tree)).items()}


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("form", ["naive", "absorbed"])
def test_mla_attention_matches_reference(form):
    jcfg, _ = _cfgs("deepseek-v2-236b")
    m, d, h = jcfg.mla, jcfg.d_model, jcfg.num_heads
    jp = j_mla.init_mla(jax.random.PRNGKey(1), d, h, m, jnp.float32)
    tp = _flat_torch(jp)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 13, d)).astype(np.float32)
    theta = jcfg.rope_theta
    if form == "naive":
        pos = np.arange(13)
        jy, _ = j_mla.mla_attention(jp, jnp.asarray(x), m,
                                    positions=jnp.asarray(pos), theta=theta)
        ty, _ = t_mla.mla_attention(tp, torch.from_numpy(x), m,
                                    positions=torch.from_numpy(pos),
                                    theta=theta)
        _close(ty, jy, 2e-5)
        return
    # a chunk of 9 at offset 3 over a cache whose first 3 rows hold an
    # earlier chunk, then one token at 12
    jc = j_mla.init_cache_mla(2, 16, m, jnp.float32)
    tc = t_mla.init_cache_mla(2, 16, m, torch.float32, torch.device("cpu"))
    for start, stop in ((0, 3), (3, 12), (12, 13)):
        pos = np.arange(start, stop)
        jy, jc = j_mla.mla_attention(
            jp, jnp.asarray(x[:, start:stop]), m, positions=jnp.asarray(pos),
            theta=theta, cache=jc, cache_idx=jnp.asarray(start, jnp.int32))
        ty, tc = t_mla.mla_attention(
            tp, torch.from_numpy(x[:, start:stop]), m,
            positions=torch.from_numpy(pos), theta=theta, cache=tc,
            cache_idx=start)
        _close(ty, jy, 2e-5)
    lat = np.concatenate([np.asarray(jc["ckv"]), np.asarray(jc["krope"])],
                         -1)
    _close(tc["latent"], lat, 2e-5)


def test_mla_absorbed_decode_matches_the_naive_forward():
    """Within the port: the absorbed form over the latent cache computes
    the naive form's function (the reference's design), to 1e-5."""
    _, cfg = _cfgs("deepseek-v2-236b")
    m, d, h = cfg.mla, cfg.d_model, cfg.num_heads
    g = torch.Generator().manual_seed(4)
    p = t_mla.init_mla(d, h, m, torch.float32, g, torch.device("cpu"))
    x = torch.randn(1, 11, d, generator=g)
    full, _ = t_mla.mla_attention(p, x, m, positions=torch.arange(11),
                                  theta=cfg.rope_theta)
    cache = t_mla.init_cache_mla(1, 11, m, torch.float32,
                                 torch.device("cpu"))
    ys = []
    for t in range(11):
        y, cache = t_mla.mla_attention(p, x[:, t:t + 1], m,
                                       positions=torch.tensor([t]),
                                       theta=cfg.rope_theta, cache=cache,
                                       cache_idx=t)
        ys.append(y)
    assert float((torch.cat(ys, 1) - full).abs().max()) < 1e-5


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

def _reference_keep(idx, E, C):
    """The reference's drop rule, computed with jnp as ``moe_ffn`` does."""
    flat_e = jnp.asarray(idx).reshape(-1)
    onehot = jax.nn.one_hot(flat_e, E, dtype=jnp.int32)
    pos = jnp.cumsum(onehot, axis=0) - onehot
    slot = jnp.take_along_axis(pos, flat_e[:, None], axis=1)[:, 0]
    return np.asarray(slot < C)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("capacity_factor", [0.25, 2.0])
def test_moe_ffn_matches_reference_with_the_same_drops(arch,
                                                       capacity_factor):
    """The router is biased towards expert 0; at capacity factor 0.25 the
    8 experts hold at most 64 of the 160 assignments, so most are
    dropped; 2.0 is the serving value below 4096 tokens."""
    jcfg, tcfg = _cfgs(arch)
    mc = dataclasses.replace(jcfg.moe, num_experts=8, top_k=2)
    tmc = dataclasses.replace(tcfg.moe, num_experts=8, top_k=2)
    jp = jax.tree.map(np.array, j_moe.init_moe(jax.random.PRNGKey(5),
                                               jcfg.d_model, mc,
                                               jnp.float32))
    jp["router"][:, 0] += 0.3
    tp = _flat_torch(jp)
    x = np.random.default_rng(6).standard_normal(
        (2, 40, jcfg.d_model)).astype(np.float32)
    jy, jaux = j_moe.moe_ffn(jax.tree.map(jnp.asarray, jp), jnp.asarray(x),
                             mc, capacity_factor=capacity_factor)
    ty, taux = t_moe.moe_ffn(tp, torch.from_numpy(x), tmc,
                             capacity_factor=capacity_factor)
    _close(ty, jy, 2e-5)
    _close(taux, jaux, 2e-5)
    T = 80
    C = t_moe.capacity(T, tmc, capacity_factor)
    _, jidx, _ = j_moe._router(jax.tree.map(jnp.asarray, jp),
                               jnp.asarray(x.reshape(T, -1)), mc)
    _, tidx, _ = t_moe._router(tp, torch.from_numpy(x.reshape(T, -1)), tmc)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    _, keep = t_moe.dispatch(tidx, 8, C)
    want = _reference_keep(jidx, 8, C)
    np.testing.assert_array_equal(keep.numpy(), want)
    if capacity_factor < 1:    # 160 assignments, 8 experts x C slots
        assert (~want).sum() >= T * 2 - 8 * C > 0


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_deepseek_matches_jax(arch):
    jcfg, tcfg = _cfgs(arch)
    jm, tm = j_build(jcfg), t_build(tcfg, "cpu")
    jp = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(7)))
    assert ("mtp" in jp) == (arch == "deepseek-v3-671b")
    tp = bridge.params_to_torch(jp, tcfg, "cpu")
    jp = jax.tree.map(jnp.asarray, jp)
    B, S, P = 2, 24, 16
    toks = np.random.default_rng(8).integers(0, tcfg.vocab_size, (B, S))
    jt, tt = jnp.asarray(toks, jnp.int32), torch.from_numpy(toks)

    jfull, jaux, _ = jm.apply(jp, {"tokens": jt}, mode="train")
    tfull, taux, _ = tm.apply(tp, {"tokens": tt}, mode="train")
    _close(tfull, jfull, 1e-3)
    _close(taux, jaux, 2e-5)
    assert float(taux) > 0

    jcache, tcache = jm.init_cache(B, S), tm.init_cache(B, S)
    jpre, jcache = jm.prefill(jp, {"tokens": jt[:, :P]}, jcache)
    tpre, tcache = tm.prefill(tp, {"tokens": tt[:, :P]}, tcache)
    _close(tpre, jpre, 1e-3)
    assert float((tpre[:, -1] - tfull[:, P - 1]).abs().max()) < 1e-3
    jids, tids = [], []
    jtok = jnp.argmax(jpre[:, -1], -1)[:, None].astype(jnp.int32)
    ttok = torch.argmax(tpre[:, -1], -1)[:, None]
    for t in range(P, S):
        jlg, jcache = jm.decode_step(jp, jtok, jcache)
        tlg, tcache = tm.decode_step(tp, ttok, tcache)
        _close(tlg, jlg, 1e-3)
        jtok = jnp.argmax(jlg, -1)[:, None].astype(jnp.int32)
        ttok = torch.argmax(tlg, -1)[:, None]
        jids.append(np.asarray(jtok)[:, 0].tolist())
        tids.append(ttok[:, 0].tolist())
    assert tids == jids
    assert tcache["idx"] == S
    tc = bridge.cache_from_torch(tcache, tcfg)
    for leaf in ("ckv", "krope"):
        _close(torch.from_numpy(tc["layers"][leaf]), jcache["layers"][leaf],
               1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_port_prefill_decode_matches_its_forward(arch):
    """The port alone (``test_models.py::test_prefill_decode_matches_
    forward``): the cached absorbed path against the naive forward."""
    _, cfg = _cfgs(arch)
    model = t_build(cfg, "cpu")
    params = model.init(9)
    toks = torch.from_numpy(np.random.default_rng(9).integers(
        0, cfg.vocab_size, (2, 20)))
    full, _, _ = model.apply(params, {"tokens": toks})
    cache = model.init_cache(2, 20)
    pre, cache = model.prefill(params, {"tokens": toks[:, :12]}, cache)
    assert float((pre - full[:, :12]).abs().max()) < 1e-3
    for t in range(12, 20):
        lg, cache = model.decode_step(params, toks[:, t:t + 1], cache)
        assert float((lg - full[:, t]).abs().max()) < 1e-3


@pytest.mark.parametrize("arch", ARCHS)
def test_serving_engine_serves_reduced_deepseek(arch):
    _, cfg = _cfgs(arch)
    params = t_build(cfg, "cpu").init(10)
    eng = ServingEngine(cfg, params, max_len=64, prefill_chunk=16,
                        token_group=4)
    rng = np.random.default_rng(10)
    for n in (5, 23, 40):
        eng.submit(rng.integers(3, cfg.vocab_size, n).tolist(), max_new=6)
    done = eng.run_to_completion()
    assert sorted(len(r.prompt_ids) for r in done) == [5, 23, 40]
    assert all(r.done and 1 <= len(r.generated) <= 6
               and all(0 <= t < cfg.vocab_size for t in r.generated)
               for r in done)
