"""The sliding-window ring cache of the hybrid family (zamba2 above 32768
positions) and the window mode of K1/K2 that it runs on.

* The window mode's plain versions (``kernels/ref.py``, what the wrappers
  run on the CPU and what the CUDA kernels are held to on the card)
  against the reference ``repro.models.layers.mha`` with the same
  per-slot ``kv_positions`` and ``window``: a ring not yet full
  (``NEG_POS`` slots), a wrapped ring, a chunk that straddles the wrap;
  and ``layers.attention``'s window over keys in position order.
  Tolerances: f32 2e-5, bf16 2e-2.
* The host-side counts the bounds are priced from (visible pairs and
  rows, K2's plan over a ring).
* Reduced zamba2 (7 layers: one group of 6 Mamba2 layers, the shared
  block, one tail layer; f32) with ``max_len`` 40000, so that its cache
  is a 4096-slot ring, against the reference through the bridge: prefill
  in chunks of 512 up to 4608 positions (the ring wraps), then 16 decode
  steps.  Logits within 1e-3 (``tests/test_models.py``'s tolerance),
  ``pos`` equal exactly, ring k/v within 1e-3, greedy ids equal.  The
  same with chunks of 1000 (which do not divide the ring) and a prefill
  after decode steps whose chunk crosses the end of the ring.  A chunk
  longer than the ring raises.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config, reduced  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.models.layers import attention as jattention  # noqa: E402
from repro.models.layers import mha as jmha  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.configs import reduced as t_reduced  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ref import ring_positions  # noqa: E402
from repro_torch.models import build_model as t_build  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402

DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _tol(dtype):
    return dict(atol=2e-2, rtol=2e-2) if dtype == "bfloat16" \
        else dict(atol=2e-5, rtol=2e-5)


def _pair(rng, shape, dtype):
    a = np.asarray(jnp.asarray(rng.standard_normal(shape).astype(np.float32),
                               DTYPES[dtype]))
    return jnp.asarray(a), bridge.to_torch(a, "cpu")


# (W, end of the written positions, queries, window): a ring not yet
# full, a full one, a wrapped one, a chunk that straddles the wrap, a
# window narrower than the ring
RINGS = [(64, 40, 5, 64), (64, 64, 1, 64), (64, 150, 1, 64),
         (64, 150, 12, 64), (64, 70, 9, 64), (64, 200, 7, 20)]


@pytest.mark.parametrize("W,end,sq,window", RINGS)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_windowed_plain_versions_match_mha(W, end, sq, window, dtype):
    rng = np.random.default_rng(40)
    b, h, n, e = 2, 8, 4, 16
    pos = ring_positions(W, end).numpy()
    jq, tq = _pair(rng, (b, sq, h, e), dtype)
    jk, tk = _pair(rng, (b, W, n, e), dtype)
    jv, tv = _pair(rng, (b, W, n, e), dtype)
    qpos = np.arange(end - sq, end, dtype=np.int32)
    want = np.asarray(jmha(jq, jk, jv, causal=True,
                           q_positions=jnp.asarray(qpos),
                           kv_positions=jnp.asarray(pos), window=window),
                      np.float32)
    tpos = torch.from_numpy(pos)
    got = ops.flash_attention(tq, tk, tv, causal=True, q_offset=end - sq,
                              kv_positions=tpos, window=window)
    np.testing.assert_allclose(got.float().numpy(), want, **_tol(dtype))
    # K1: the last query alone, as a decode step sees the ring
    got1 = ops.decode_attention(
        tq[:, -1], tk, tv, torch.full((b,), W, dtype=torch.int32),
        kv_positions=tpos, q_pos=torch.full((b,), end - 1,
                                            dtype=torch.int32),
        window=window)
    np.testing.assert_allclose(got1.float().numpy(), want[:, -1],
                               **_tol(dtype))


def test_windowed_plain_versions_in_position_order_match_mha():
    """A window over keys in position order, as ``layers.attention`` runs
    it (slot i holds position i): over the sequence with no cache, then a
    prefill chunk and a decode step into a cache, against the reference's
    ``attention`` with the same window."""
    rng = np.random.default_rng(41)
    d, h, n, e, window = 32, 4, 2, 16, 9
    jp, tp = {}, {}
    for name, shape in (("wq", (d, h, e)), ("wk", (d, n, e)),
                        ("wv", (d, n, e)), ("wo", (h, e, d))):
        w = (rng.standard_normal(shape) / np.sqrt(shape[0])).astype(
            np.float32)
        jp[name], tp[name] = jnp.asarray(w), torch.from_numpy(w)
    jx, tx = _pair(rng, (2, 12, d), "float32")
    kw = dict(theta=1e4, window=window)
    want, _ = jattention(jp, jx, positions=jnp.arange(12), **kw)
    got, _ = tlayers.attention(tp, tx, positions=torch.arange(12), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **_tol("float32"))
    jc = {k: jnp.zeros((2, 48, n, e), jnp.float32) for k in ("k", "v")}
    tc = {k: torch.zeros((2, 48, n, e)) for k in ("k", "v")}
    for start, sq in ((0, 12), (12, 1)):
        x = jx[:, :sq] if sq > 1 else jx[:, -1:]
        want, jc = jattention(jp, x, positions=jnp.arange(start, start + sq),
                              cache=jc, cache_idx=start, **kw)
        got, tc = tlayers.attention(
            tp, torch.from_numpy(np.array(x)),
            positions=torch.arange(start, start + sq), cache=tc,
            cache_idx=start, **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **_tol("float32"))


def test_window_counts_follow_the_positions():
    """The bounds count the pairs and rows the window leaves: a wrapped
    4096-slot ring at zamba2's shapes (decode sees all 4096 slots; a
    128-query chunk sees i + W - 127 keys for query i), a ring not yet
    full, and K2's plan visits every slot tile of a ring."""
    from repro_torch.kernels import decode_attention as k1
    from repro_torch.kernels import flash_attention as k2
    W = 4096
    pos = ring_positions(W, 4608)
    one = torch.ones(1, dtype=torch.int32)
    assert k1.visible_keys(one * W, W, kv_positions=pos, q_pos=one * 4607,
                           window=W) == W
    part = ring_positions(W, 300)
    assert k1.visible_keys(one * W, W, kv_positions=part, q_pos=one * 299,
                           window=W) == 300
    assert k2.visible_pairs(128, W, True, 4480, pos, W) == sum(
        i + W - 127 for i in range(128))
    q = torch.zeros(1, 128, 32, 64, dtype=torch.bfloat16)
    k = torch.zeros(1, W, 32, 64, dtype=torch.bfloat16)
    assert k2.bytes_moved(q, k, W, q_offset=4480, kv_positions=pos,
                          window=W) == (2 * q.numel() * 2 + 4 * W
                                        + 2 * W * 32 * 64 * 2)
    per_tile, mtiles, chunk, nsplit = k2.plan(1, 128, 32, 32, W, True, 4480,
                                              ring=True)
    assert (nsplit - 1) * chunk < W <= nsplit * chunk
    # position order: a causal chunk at an offset stops at its last query
    assert k2.plan(1, 128, 32, 32, W, True, 0)[2:] == (128, 1)


def _zamba2():
    jcfg = reduced(get_config("zamba2-1.2b"), layers=7)
    tcfg = t_reduced(t_get_config("zamba2-1.2b"), layers=7)
    jm, tm = j_build(jcfg), t_build(tcfg, "cpu")
    jp = jm.init(jax.random.PRNGKey(5))
    tp = bridge.params_to_torch(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return jm, tm, jp, tp, tcfg


def _close(t, j, atol):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=atol, rtol=0)


def test_ring_cache_prefill_and_decode_match_the_reference():
    jm, tm, jp, tp, cfg = _zamba2()
    jc, tc = jm.init_cache(1, 40000), tm.init_cache(1, 40000)
    assert tuple(tc["attn"]["pos"].shape) == (1, 4096)
    j_prefill, j_decode = jax.jit(jm.prefill), jax.jit(jm.decode_step)
    toks = np.random.default_rng(6).integers(3, cfg.vocab_size, (1, 4608))
    for c0 in range(0, 4608, 512):
        chunk = toks[:, c0:c0 + 512]
        jl, jc = j_prefill(jp, {"tokens": jnp.asarray(chunk, jnp.int32)},
                           jc)
        tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(chunk)}, tc)
        _close(tl, jl, 1e-3)
    assert tc["idx"] == 4608
    np.testing.assert_array_equal(tc["attn"]["pos"].numpy(),
                                  np.asarray(jc["attn"]["pos"]))
    for leaf in ("k", "v"):
        _close(tc["attn"][leaf], jc["attn"][leaf], 1e-3)
    jt = int(np.argmax(np.asarray(jl[0, -1])))
    tt = int(torch.argmax(tl[0, -1]))
    j_ids, t_ids = [jt], [tt]
    for _ in range(16):
        jl, jc = j_decode(jp, jnp.asarray([[j_ids[-1]]], jnp.int32), jc)
        tl, tc = tm.decode_step(tp, torch.tensor([[t_ids[-1]]]), tc)
        _close(tl, jl, 1e-3)
        j_ids.append(int(np.argmax(np.asarray(jl[0]))))
        t_ids.append(int(torch.argmax(tl[0])))
    assert t_ids == j_ids
    np.testing.assert_array_equal(tc["attn"]["pos"].numpy(),
                                  np.asarray(jc["attn"]["pos"]))
    assert int(tc["attn"]["pos"].max()) == 4608 + 15


def test_ring_cache_chunks_across_the_end_of_the_ring_match_the_reference():
    """Chunks of 1000, which do not divide the 4096 slots, then decode
    steps, then a prefill chunk of 500 from position 4003: it writes its
    first 93 slots at the end of the ring and the rest at its start."""
    jm, tm, jp, tp, cfg = _zamba2()
    jc, tc = jm.init_cache(1, 40000), tm.init_cache(1, 40000)
    j_prefill, j_decode = jax.jit(jm.prefill), jax.jit(jm.decode_step)
    toks = np.random.default_rng(7).integers(3, cfg.vocab_size, (1, 4500))

    def prefill(chunk):
        nonlocal jc, tc
        jl, jc = j_prefill(jp, {"tokens": jnp.asarray(chunk, jnp.int32)},
                           jc)
        tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(chunk)}, tc)
        _close(tl, jl, 1e-3)
        return int(torch.argmax(tl[0, -1]))

    def decode(tok):
        nonlocal jc, tc
        jl, jc = j_decode(jp, jnp.asarray([[tok]], jnp.int32), jc)
        tl, tc = tm.decode_step(tp, torch.tensor([[tok]]), tc)
        _close(tl, jl, 1e-3)
        assert int(torch.argmax(tl[0])) == int(np.argmax(np.asarray(jl[0])))
        return int(torch.argmax(tl[0]))

    for c0 in range(0, 4000, 1000):
        tok = prefill(toks[:, c0:c0 + 1000])
    for _ in range(3):
        tok = decode(tok)
    assert tc["idx"] == 4003
    tok = prefill(toks[:, 4000:4500])
    assert tc["idx"] == 4503
    decode(tok)
    pos = tc["attn"]["pos"].numpy()
    np.testing.assert_array_equal(pos, np.asarray(jc["attn"]["pos"]))
    assert (pos[0, 4095], pos[0, 0], pos[0, 406]) == (4095, 4096, 4502)
    assert (pos[0, 407], pos[0, 408]) == (4503, 408)
    for leaf in ("k", "v"):
        _close(tc["attn"][leaf], jc["attn"][leaf], 1e-3)


def test_ring_cache_refuses_a_chunk_longer_than_the_ring():
    cfg = t_reduced(t_get_config("zamba2-1.2b"), layers=7)
    model = t_build(cfg, "cpu")
    params = model.init(0)
    cache = model.init_cache(1, 40000)
    with pytest.raises(ValueError, match="longer than the 4096-slot ring"):
        model.prefill(params, {"tokens": torch.zeros((1, 4097),
                                                     dtype=torch.int64)},
                      cache)
