"""The ssm family (xLSTM: mLSTM and sLSTM blocks) of the port against
``repro.models`` on bridged weights, in f32.

``_mlstm_chunk`` on a carried state, ``mlstm_forward`` at lengths that
are not a multiple of the chunk (the padded steps must leave the state
alone) and ``slstm_forward`` match the reference within 2e-5 (atol and
rtol: the kernel sweep's f32 tolerance), states included.  Reduced
xlstm-350m (4 layers, so the sLSTM at layer 3 is in it): the train
forward, a prefill and decode steps match the reference's logits within
1e-3 with equal greedy ids, and the port's own prefill + decode match its
forward within 1e-3 (``tests/test_models.py``'s tolerances)."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config, reduced  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.models import xlstm as j_xl  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.configs import reduced as t_reduced  # noqa: E402
from repro_torch.models import build_model as t_build  # noqa: E402
from repro_torch.models import xlstm as t_xl  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402

ARCH = "xlstm-350m"


def _close(t, j, atol):
    """|t - j| <= atol (+ atol·|j| at the f32 kernel tolerance 2e-5, as
    ``tests/test_kernels.py`` takes it)."""
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=atol,
                               rtol=atol if atol <= 2e-5 else 0)


def _cfgs(layers=4):
    return (reduced(get_config(ARCH), layers=layers),
            t_reduced(t_get_config(ARCH), layers=layers))


def _torch_tree(tree):
    return {k: bridge.to_torch(np.asarray(v), "cpu") for k, v in tree.items()}


def _state(rng, b, H, P):
    """A carried mLSTM state with a live stabiliser."""
    C = rng.standard_normal((b, H, P, P)).astype(np.float32) * 0.1
    n = rng.standard_normal((b, H, P)).astype(np.float32) * 0.1
    m = rng.standard_normal((b, H)).astype(np.float32)
    return C, n, m


def test_mlstm_chunk_matches_reference():
    rng = np.random.default_rng(1)
    b, Q, H, P = 2, 16, 3, 8
    q, k, v = (rng.standard_normal((b, Q, H, P)).astype(np.float32)
               for _ in range(3))
    ig = rng.standard_normal((b, Q, H)).astype(np.float32)
    fg = (rng.standard_normal((b, Q, H)) + 2).astype(np.float32)
    st = _state(rng, b, H, P)
    jh, (jC, jn, jm) = j_xl._mlstm_chunk(*map(jnp.asarray, (q, k, v, ig, fg)),
                                          tuple(map(jnp.asarray, st)))
    th, (tC, tn, tm) = t_xl._mlstm_chunk(
        *map(torch.from_numpy, (q, k, v, ig, fg)),
        tuple(map(torch.from_numpy, st)))
    for t, j in ((th, jh), (tC, jC), (tn, jn), (tm, jm)):
        _close(t, j, 2e-5)


@pytest.mark.parametrize("length,carried", [(45, False), (45, True),
                                            (7, True), (64, False)])
def test_mlstm_forward_matches_reference(length, carried):
    """Chunks of 32: 45 = one full chunk and a padded one; 7 a single
    short chunk; 64 two full ones.  ``carried`` starts from a state."""
    jcfg, tcfg = _cfgs()
    d, s = jcfg.d_model, jcfg.ssm
    jp = j_xl.init_mlstm(jax.random.PRNGKey(2), d, s, jnp.float32)
    tp = _torch_tree(jp)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, length, d)).astype(np.float32)
    H, P = s.expand * d // s.head_dim, s.head_dim
    jst = tst = None
    if carried:
        C, n, m = _state(rng, 2, H, P)
        conv = rng.standard_normal((2, s.conv_kernel - 1, s.expand * d))
        st = {"C": C, "n": n, "m": m, "conv": conv.astype(np.float32)}
        jst = {k: jnp.asarray(v) for k, v in st.items()}
        tst = {k: torch.from_numpy(v) for k, v in st.items()}
    jy, jnew = j_xl.mlstm_forward(jp, jnp.asarray(x), s, init_state=jst,
                                  return_state=True)
    ty, tnew = t_xl.mlstm_forward(tp, torch.from_numpy(x), s,
                                  init_state=tst, return_state=True)
    _close(ty, jy, 2e-5)
    assert sorted(tnew) == sorted(jnew)
    for k in jnew:
        _close(tnew[k], jnew[k], 2e-5)


@pytest.mark.parametrize("carried", [False, True])
def test_slstm_forward_matches_reference(carried):
    jcfg, _ = _cfgs()
    d = jcfg.d_model
    jp = jax.tree.map(np.array, j_xl.init_slstm(jax.random.PRNGKey(4), d,
                                                jnp.float32))
    jp["bias"] = np.random.default_rng(5).standard_normal(
        4 * d).astype(np.float32)
    tp = _torch_tree(jp)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 11, d)).astype(np.float32)
    jst = tst = None
    if carried:
        st = {k: rng.standard_normal((2, d)).astype(np.float32)
              for k in "cnhm"}
        st["n"] = np.abs(st["n"]) + 0.5
        jst = {k: jnp.asarray(v) for k, v in st.items()}
        tst = {k: torch.from_numpy(v) for k, v in st.items()}
    jy, jnew = j_xl.slstm_forward(jax.tree.map(jnp.asarray, jp),
                                  jnp.asarray(x), init_state=jst,
                                  return_state=True)
    ty, tnew = t_xl.slstm_forward(tp, torch.from_numpy(x), init_state=tst,
                                  return_state=True)
    _close(ty, jy, 2e-5)
    for k in "cnhm":
        _close(tnew[k], jnew[k], 2e-5)


def test_reduced_xlstm_matches_jax():
    jcfg, tcfg = _cfgs()
    assert tcfg.ssm.slstm_layers == (3,)
    jm, tm = j_build(jcfg), t_build(tcfg, "cpu")
    jp = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(7)))
    tp = bridge.params_to_torch(jp, tcfg, "cpu")
    assert [b.slstm is not None for b in tp.blocks] == [False] * 3 + [True]
    jp = jax.tree.map(jnp.asarray, jp)
    B, S, P = 2, 44, 37          # a prefill of one full chunk and a tail
    toks = np.random.default_rng(8).integers(0, tcfg.vocab_size, (B, S))
    jt, tt = jnp.asarray(toks, jnp.int32), torch.from_numpy(toks)
    jfull, _, _ = jm.apply(jp, {"tokens": jt}, mode="train")
    tfull, _, _ = tm.apply(tp, {"tokens": tt}, mode="train")
    _close(tfull, jfull, 1e-3)

    jcache, tcache = jm.init_cache(B, S), tm.init_cache(B, S)
    jpre, jcache = jm.prefill(jp, {"tokens": jt[:, :P]}, jcache)
    tpre, tcache = tm.prefill(tp, {"tokens": tt[:, :P]}, tcache)
    _close(tpre, jpre, 1e-3)
    jids, tids = [], []
    jtok = jnp.argmax(jpre[:, -1], -1)[:, None].astype(jnp.int32)
    ttok = torch.argmax(tpre[:, -1], -1)[:, None]
    for _ in range(P, S):
        jlg, jcache = jm.decode_step(jp, jtok, jcache)
        tlg, tcache = tm.decode_step(tp, ttok, tcache)
        _close(tlg, jlg, 1e-3)
        jtok = jnp.argmax(jlg, -1)[:, None].astype(jnp.int32)
        ttok = torch.argmax(tlg, -1)[:, None]
        jids.append(np.asarray(jtok)[:, 0].tolist())
        tids.append(ttok[:, 0].tolist())
    assert tids == jids
    tc = bridge.cache_from_torch(tcache)
    for kind in ("mlstm", "slstm"):
        for leaf, v in tc[kind].items():
            _close(torch.from_numpy(v), jcache[kind][leaf], 1e-3)


def test_port_prefill_decode_matches_its_forward():
    _, cfg = _cfgs()
    model = t_build(cfg, "cpu")
    params = model.init(9)
    toks = torch.from_numpy(np.random.default_rng(9).integers(
        0, cfg.vocab_size, (2, 50)))
    full, aux, _ = model.apply(params, {"tokens": toks})
    assert float(aux) == 0.0
    cache = model.init_cache(2, 50)
    pre, cache = model.prefill(params, {"tokens": toks[:, :40]}, cache)
    assert float((pre - full[:, :40]).abs().max()) < 1e-3
    for t in range(40, 50):
        lg, cache = model.decode_step(params, toks[:, t:t + 1], cache)
        assert float((lg - full[:, t]).abs().max()) < 1e-3


def test_serving_engine_serves_reduced_xlstm():
    _, cfg = _cfgs()
    params = t_build(cfg, "cpu").init(10)
    eng = ServingEngine(cfg, params, max_len=96, prefill_chunk=32,
                        token_group=4)
    rng = np.random.default_rng(10)
    for n in (5, 33, 70):
        eng.submit(rng.integers(3, cfg.vocab_size, n).tolist(), max_new=6)
    done = eng.run_to_completion()
    assert sorted(len(r.prompt_ids) for r in done) == [5, 33, 70]
    assert all(r.done and 1 <= len(r.generated) <= 6
               and all(0 <= t < cfg.vocab_size for t in r.generated)
               for r in done)
