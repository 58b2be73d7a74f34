"""Dense layers of the PyTorch port against ``repro.models.layers`` on the
same numpy inputs.  f32, atol/rtol 2e-5: the two frameworks sum in other
orders, nothing more."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import layers as JL  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402

TOL = dict(atol=2e-5, rtol=2e-5)


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _close(t, j):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **TOL)


def _both(tree):
    return ({k: jnp.asarray(v) for k, v in tree.items()},
            {k: torch.from_numpy(v) for k, v in tree.items()})


def test_rmsnorm():
    rng = np.random.default_rng(0)
    x, scale = _rand(rng, 2, 5, 32), _rand(rng, 32)
    jp, tp = _both({"scale": scale})
    _close(TL.rmsnorm(tp, torch.from_numpy(x), 1e-6),
           JL.rmsnorm(jp, jnp.asarray(x), 1e-6))


@pytest.mark.parametrize("offset", [0, 37])
def test_apply_rope_split_half(offset):
    rng = np.random.default_rng(1)
    x = _rand(rng, 2, 7, 4, 16)
    pos = np.arange(7) + offset
    _close(TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e4),
           JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4))


MHA_CASES = {
    "causal": dict(causal=True),
    "full": dict(causal=False),
    "q_positions_offset": dict(causal=True, q_positions=np.arange(6) + 4),
    "kv_valid_len": dict(causal=False, kv_valid_len=np.array([10, 3])),
    # row 1 of the batch sees no key at all: its output is 0
    "fully_masked_row": dict(causal=True, q_positions=np.arange(6) + 4,
                             kv_valid_len=np.array([7, 0])),
}


@pytest.mark.parametrize("case", sorted(MHA_CASES))
def test_mha(case):
    rng = np.random.default_rng(2)
    q, k, v = _rand(rng, 2, 6, 4, 16), _rand(rng, 2, 10, 2, 16), \
        _rand(rng, 2, 10, 2, 16)
    kw = MHA_CASES[case]
    jkw = {n: (jnp.asarray(a) if isinstance(a, np.ndarray) else a)
           for n, a in kw.items()}
    tkw = {n: (torch.from_numpy(a) if isinstance(a, np.ndarray) else a)
           for n, a in kw.items()}
    out = TL.mha(torch.from_numpy(q), torch.from_numpy(k),
                 torch.from_numpy(v), **tkw)
    _close(out, JL.mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       **jkw))
    if case == "fully_masked_row":
        assert float(out[1].abs().max()) == 0.0


def _attn_params(rng, d, h, n, e, bias):
    p = {"wq": _rand(rng, d, h, e, scale=d ** -0.5),
         "wk": _rand(rng, d, n, e, scale=d ** -0.5),
         "wv": _rand(rng, d, n, e, scale=d ** -0.5),
         "wo": _rand(rng, h, e, d, scale=(h * e) ** -0.5)}
    if bias:
        p.update(bq=_rand(rng, h, e), bk=_rand(rng, n, e),
                 bv=_rand(rng, n, e))
    return p


@pytest.mark.parametrize("bias", [False, True])
def test_attention_no_cache(bias):
    rng = np.random.default_rng(3)
    d, h, n, e, s = 32, 4, 2, 8, 9
    jp, tp = _both(_attn_params(rng, d, h, n, e, bias))
    x = _rand(rng, 2, s, d)
    pos = np.arange(s)
    ty, tc = TL.attention(tp, torch.from_numpy(x),
                          positions=torch.from_numpy(pos), theta=1e4)
    jy, _ = JL.attention(jp, jnp.asarray(x), positions=jnp.asarray(pos),
                         theta=1e4)
    assert tc is None
    _close(ty, jy)


@pytest.mark.parametrize("sq", [1, 5])
@pytest.mark.parametrize("bias", [False, True])
def test_attention_with_cache_at_offset(sq, bias):
    """Prefill chunk (sq > 1, the flash path) and decode (sq == 1, the
    decode path) into a cache that already holds ``idx`` positions."""
    rng = np.random.default_rng(4)
    d, h, n, e, S, idx = 32, 4, 2, 8, 16, 6
    jp, tp = _both(_attn_params(rng, d, h, n, e, bias))
    x = _rand(rng, 2, sq, d)
    pos = np.arange(sq) + idx
    kc, vc = _rand(rng, 2, S, n, e), _rand(rng, 2, S, n, e)
    tcache = {"k": torch.from_numpy(kc.copy()),
              "v": torch.from_numpy(vc.copy())}
    ty, tnew = TL.attention(tp, torch.from_numpy(x),
                            positions=torch.from_numpy(pos), theta=1e4,
                            cache=tcache, cache_idx=idx)
    jy, jnew = JL.attention(jp, jnp.asarray(x), positions=jnp.asarray(pos),
                            theta=1e4,
                            cache={"k": jnp.asarray(kc), "v": jnp.asarray(vc)},
                            cache_idx=jnp.asarray(idx, jnp.int32))
    _close(ty, jy)
    assert tnew is tcache            # written in place
    _close(tnew["k"], jnew["k"])
    _close(tnew["v"], jnew["v"])


@pytest.mark.parametrize("gated", [True, False])
def test_mlp(gated):
    rng = np.random.default_rng(5)
    d, f = 16, 40
    p = {"w_up": _rand(rng, d, f, scale=d ** -0.5),
         "w_down": _rand(rng, f, d, scale=f ** -0.5)}
    if gated:
        p["w_gate"] = _rand(rng, d, f, scale=d ** -0.5)
    jp, tp = _both(p)
    x = _rand(rng, 2, 3, d)
    _close(TL.mlp(tp, torch.from_numpy(x)), JL.mlp(jp, jnp.asarray(x)))


def test_sliding_window_plain_path():
    """window > 0 is off the dense path: it runs the plain mha on the CPU
    (on a CUDA tensor it raises, having no kernel yet)."""
    rng = np.random.default_rng(6)
    d, h, n, e, s = 32, 4, 2, 8, 6
    jp, tp = _both(_attn_params(rng, d, h, n, e, False))
    x = _rand(rng, 1, s, d)
    pos = np.arange(s)
    ty, _ = TL.attention(tp, torch.from_numpy(x),
                         positions=torch.from_numpy(pos), theta=1e4,
                         window=3)
    jy, _ = JL.attention(jp, jnp.asarray(x), positions=jnp.asarray(pos),
                         theta=1e4, window=3)
    _close(ty, jy)
