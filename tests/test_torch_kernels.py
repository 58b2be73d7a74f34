"""Kernels K1-K5 of the PyTorch port.

On the CPU: the plain PyTorch versions (``repro_torch.kernels.ref``, what
the wrappers run for a CPU tensor) against the Pallas TPU kernels run in
interpret mode, on the sweeps of ``tests/test_kernels.py``, and against
the JAX ``mha`` where the port's kernels go beyond the Pallas ones
(``q_offset``/``kv_len``, a length-0 decode row).  Tolerances: f32 2e-5,
bf16 2e-2, top-k values 1e-4 with ids exactly equal, int8 product 1e-2
(the reference sweep's; the port's is exact), SSD chunk 2e-4.

The CUDA kernels themselves are held to these plain versions in
``tests/test_torch_cuda.py``, on a card.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.decode_attention import decode_attention as pl_decode  # noqa: E402
from repro.kernels.flash_attention import flash_attention as pl_flash  # noqa: E402
from repro.kernels.int8_matmul import int8_matmul as pl_int8  # noqa: E402
from repro.kernels.int8_matmul import quantize_int8 as jquantize  # noqa: E402
from repro.kernels.mamba2_scan import ssd_chunk as pl_ssd  # noqa: E402
from repro.kernels.topk_retrieval import topk_retrieval as pl_topk  # noqa: E402
from repro.models.layers import mha as jmha  # noqa: E402
from repro_torch.bridge import to_torch  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.int8_matmul import quantize_int8  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(dtype):
    return dict(atol=2e-2, rtol=2e-2) if dtype == "bfloat16" \
        else dict(atol=2e-5, rtol=2e-5)


def _pair(rng, shape, dtype):
    """The same values as a jax array and a CPU torch tensor."""
    a = np.asarray(jnp.asarray(rng.standard_normal(shape).astype(np.float32),
                               DTYPES[dtype][0]))
    return jnp.asarray(a), to_torch(a, "cpu")


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# -- K2 flash attention ------------------------------------------------------

@pytest.mark.parametrize("sq,sk,h,n,e,causal", [
    (128, 128, 8, 4, 64, True), (128, 128, 8, 4, 64, False),
    (256, 128, 4, 4, 128, False),
    (64, 192, 8, 2, 64, True), (64, 192, 8, 2, 64, False),
    (128, 128, 8, 8, 128, True), (128, 128, 8, 8, 128, False),
])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_flash_plain_matches_pallas(sq, sk, h, n, e, causal, dtype):
    rng = np.random.default_rng(10)
    jq, tq = _pair(rng, (2, sq, h, e), dtype)
    jk, tk = _pair(rng, (2, sk, n, e), dtype)
    jv, tv = _pair(rng, (2, sk, n, e), dtype)
    want = pl_flash(jq, jk, jv, causal=causal, block_q=64, block_k=64,
                    interpret=True)
    got = ops.flash_attention(tq, tk, tv, causal=causal)
    assert got.dtype == DTYPES[dtype][1]
    np.testing.assert_allclose(_f32(got), _f32(want), **_tol(dtype))


@pytest.mark.parametrize("sq,sk,q_offset,kv_len", [
    (5, 16, 6, 11),     # prefill chunk into a cache at cache_idx=6
    (1, 16, 9, 10),     # one token at the end of the valid prefix
    (4, 12, 0, 12),
])
def test_flash_q_offset_kv_len_matches_mha(sq, sk, q_offset, kv_len):
    rng = np.random.default_rng(11)
    jq, tq = _pair(rng, (2, sq, 4, 16), "float32")
    jk, tk = _pair(rng, (2, sk, 2, 16), "float32")
    jv, tv = _pair(rng, (2, sk, 2, 16), "float32")
    want = jmha(jq, jk, jv, causal=True,
                q_positions=jnp.arange(sq) + q_offset,
                kv_valid_len=jnp.full((2,), kv_len, jnp.int32))
    got = ops.flash_attention(tq, tk, tv, causal=True, q_offset=q_offset,
                              kv_len=kv_len)
    np.testing.assert_allclose(_f32(got), _f32(want), **_tol("float32"))


@pytest.mark.parametrize("sq,sk,h,n,e,causal,q_offset,kv_len", [
    (16, 16, 4, 4, 16, True, 0, None),      # g = 1
    (16, 16, 8, 4, 16, True, 0, None),      # g = 2
    (24, 24, 8, 2, 64, True, 0, None),      # g = 4
    (16, 16, 8, 2, 64, False, 0, None),
    (12, 20, 8, 2, 16, False, 0, 17),       # kv_len < sk
    (5, 16, 4, 1, 16, True, 6, 11),         # a chunk at an offset, g = 4
    (32, 32, 4, 4, 128, True, 0, None),
])
def test_flash_bwd_plain_matches_jax_vjp_of_mha(sq, sk, h, n, e, causal,
                                                 q_offset, kv_len):
    """K2's backward in plain form (and the forward's LSE) against
    ``jax.vjp`` of the reference attention, f32: the LSE within 2e-5, each
    gradient within 2e-5 + 1e-4·|want| (sums over up to 32 keys and 4
    query heads of a kv head)."""
    import jax
    from repro_torch.kernels import ref as tref
    rng = np.random.default_rng(12)
    jq, tq = _pair(rng, (2, sq, h, e), "float32")
    jk, tk = _pair(rng, (2, sk, n, e), "float32")
    jv, tv = _pair(rng, (2, sk, n, e), "float32")
    jdo, tdo = _pair(rng, (2, sq, h, e), "float32")
    valid = None if kv_len is None else jnp.full((2,), kv_len, jnp.int32)
    want, vjp = jax.vjp(lambda q, k, v: jmha(
        q, k, v, causal=causal, q_positions=jnp.arange(sq) + q_offset,
        kv_valid_len=valid), jq, jk, jv)
    mask = dict(causal=causal, q_offset=q_offset, kv_len=kv_len)
    out, lse = tref.flash_attention_lse_ref(tq, tk, tv, **mask)
    np.testing.assert_allclose(_f32(out), _f32(want), **_tol("float32"))
    scores = np.einsum("bqnge,bkne->bngqk",
                       _f32(tq).reshape(2, sq, n, h // n, e), _f32(tk))
    scores = scores / np.sqrt(e)
    kpos = np.arange(sk)
    vis = kpos[None] < (sk if kv_len is None else kv_len)
    if causal:
        vis = vis & (np.arange(sq)[:, None] + q_offset >= kpos[None])
    m = np.where(vis, scores, -np.inf)
    mx = m.max(-1, keepdims=True)
    want_lse = (np.log(np.exp(m - mx).sum(-1)) + mx[..., 0]).reshape(
        2, h, sq)
    np.testing.assert_allclose(_f32(lse), want_lse, **_tol("float32"))
    got = tref.flash_attention_bwd_ref(tq, tk, tv, out, tdo, lse, **mask)
    for name, g, w in zip(("dq", "dk", "dv"), got, vjp(jdo)):
        assert g.shape == tuple(w.shape) and g.dtype == torch.float32
        np.testing.assert_allclose(_f32(g), _f32(w), atol=2e-5, rtol=1e-4,
                                   err_msg=name)


@pytest.mark.parametrize("b,sq,h,kv_len,causal,q_offset,want", [
    (8, 256, 16, 256, True, 0, (256, 1)),       # training: 512 dQ blocks
    (2, 256, 32, 256, True, 0, (128, 2)),       # g = 8 at b = 2: 256 -> 512
    (1, 16, 64, 1601, False, 0, (384, 5)),      # cross: 64 -> 320 blocks
    (1, 1500, 20, 1500, False, 0, (1536, 1)),   # whisper's encoder
    (2, 77, 8, 101, True, 24, (128, 1)),        # one split covers 101 keys
    (1, 8, 8, 0, False, 0, (64, 1)),            # kv_len 0: one empty split
])
def test_flash_bwd_plan_splits_dq_only_where_blocks_are_few(
        b, sq, h, kv_len, causal, q_offset, want):
    from repro_torch.kernels import flash_attention_bwd as kb
    chunk, nsplit = kb.plan(b, sq, h, kv_len, causal, q_offset)
    assert (chunk, nsplit) == want
    kend = min(kv_len, q_offset + sq) if causal else kv_len
    assert chunk % kb.TILE == 0 and chunk * nsplit >= kend
    assert (nsplit - 1) * chunk < max(kend, 1)      # no split is empty


# the bf16 route's plan at tests/test_torch_cuda.py's BWD_CASES shapes (b,
# sq, h, sk, n, causal, q_offset, kv_len) -> (per_tile, mtiles, kv_nsplit,
# chunk, nsplit) and (dK/dV blocks, dQ blocks)
@pytest.mark.parametrize("b,sq,h,sk,n,causal,q_offset,kv_len,want,blocks", [
    (8, 256, 16, 256, 16, True, 0, 256, (64, 4, 1, 256, 1), (512, 512)),
    (2, 256, 8, 256, 4, True, 0, 256, (32, 8, 4, 128, 2), (128, 128)),
    (2, 256, 16, 256, 4, True, 0, 256, (16, 16, 8, 128, 2), (256, 256)),
    (2, 256, 32, 256, 4, True, 0, 256, (8, 32, 8, 128, 2), (256, 512)),
    (1, 1500, 20, 1500, 20, False, 0, 1500, (64, 24, 1, 1536, 1),
     (480, 480)),
    (1, 16, 64, 1601, 8, False, 0, 1601, (8, 2, 1, 128, 13), (208, 208)),
    (2, 77, 8, 128, 4, True, 24, 101, (32, 3, 1, 128, 1), (16, 24)),
    (2, 40, 4, 40, 2, True, 0, 40, (32, 2, 1, 64, 1), (4, 8)),
    (2, 50, 12, 70, 4, False, 0, 70, (21, 3, 1, 128, 1), (16, 24)),
])
def test_flash_bwd_wgmma_plan_fills_the_card_where_the_shape_allows(
        b, sq, h, sk, n, causal, q_offset, kv_len, want, blocks):
    """Each pass of the bf16 route splits its range only while its blocks
    are under two an SM, and as far as MIN_SPLIT_TILES lets it: the dK/dV
    pass its query tiles (a block per 64 keys of a kv head), the dQ pass
    its keys (a block per 64-row query tile of the g heads); no split is
    empty."""
    from repro_torch.kernels import flash_attention_bwd as kb
    p = kb.wgmma_plan(b, sq, h, n, sk, kv_len, causal, q_offset)
    # grids of flash_bwd_dkdv_wgmma (64 keys x split, n, b) and
    # flash_bwd_dq_wgmma (query tile x split, n, b)
    assert tuple(p) == want and (b * n * -(-sk // kb.TILE) * p.kv_nsplit,
                                 b * n * p.mtiles * p.nsplit) == blocks
    g = h // n
    assert p.per_tile == kb.TILE // g and p.per_tile * p.mtiles >= sq
    kend = min(kv_len, q_offset + sq) if causal else kv_len
    key_tiles = -(-kend // kb.TILE)
    assert p.chunk % kb.TILE == 0 and p.chunk * p.nsplit >= kend
    assert (p.nsplit - 1) * p.chunk < max(kend, 1)
    # each pass: two blocks an SM within one split, or as many splits as
    # its tiles allow; and no split more than that needs
    for base, ns, tiles in ((b * n * -(-kv_len // kb.TILE), p.kv_nsplit,
                             p.mtiles),
                            (b * n * p.mtiles, p.nsplit, key_tiles)):
        assert ns <= max(1, tiles // kb.MIN_SPLIT_TILES)
        assert base * (ns + 1) > 2 * kb.SMS or \
            ns == max(1, tiles // kb.MIN_SPLIT_TILES)
        assert ns == 1 or base * (ns - 1) < 2 * kb.SMS


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("e", [16, 64, 128])
def test_flash_bwd_routes_bf16_to_wgmma_and_f32_to_the_cuda_cores(
        dtype, e, monkeypatch):
    """The backward wrapper's host side, run on CPU tensors against a
    stand-in library: bf16 at every head dim goes to the wgmma entry
    point (``flash_bwd_dkdv_wgmma``/``flash_bwd_dq_wgmma``) with
    ``wgmma_plan``'s launch, f32 to the CUDA-core one with ``plan``'s;
    each call passes as many arguments as its entry point declares.  A
    bf16 call packing more than 64 query heads a kv head raises."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention_bwd as kb
    calls = []

    class Lib:
        def __getattr__(self, name):
            def fn(*args):
                calls.append((name, args))
                return 0
            return fn

    monkeypatch.setattr(_build, "check_cuda", lambda *a: None)
    monkeypatch.setattr(_build, "library", lambda *a: Lib())
    monkeypatch.setattr(_build, "stream_ptr", lambda t: 0)
    dt = DTYPES[dtype][1]
    b, sq, h, sk, n = 1, 16, 64, 1601, 8       # the cross shape: dQ split
    q, k = torch.zeros(b, sq, h, e, dtype=dt), torch.zeros(b, sk, n, e,
                                                             dtype=dt)
    lse = torch.zeros(b, h, sq)
    dq, dk, dv = kb.flash_attention_bwd(q, k, k, q, q, lse, causal=False)
    assert dq.shape == q.shape and dk.shape == dv.shape == k.shape
    assert dq.dtype == dk.dtype == dt
    [(name, args)] = calls
    assert len(args) == len(kb._SIG[name])
    if dtype == "bfloat16":
        assert kb.kernel_for(dt) == ("flash_bwd_dkdv_wgmma",
                                     "flash_bwd_dq_wgmma")
        assert name == "repro_flash_attention_bwd_wgmma"
        p = kb.wgmma_plan(b, sq, h, n, sk, sk, False, 0)
        assert args[12:18] == (b, sq, h, n, sk, e)
        assert args[-5:-1] == (p.per_tile, p.kv_nsplit, p.chunk, p.nsplit)
        assert (args[10] is None) == (p.kv_nsplit == 1)
        assert args[11] is not None and p.nsplit > 1
        with pytest.raises(ValueError, match="at most 64"):
            kb.flash_attention_bwd(torch.zeros(1, 4, 128, e, dtype=dt),
                                   torch.zeros(1, 8, 1, e, dtype=dt),
                                   torch.zeros(1, 8, 1, e, dtype=dt),
                                   torch.zeros(1, 4, 128, e, dtype=dt),
                                   torch.zeros(1, 4, 128, e, dtype=dt),
                                   torch.zeros(1, 128, 4), causal=True)
    else:
        assert kb.kernel_for(dt) == ("flash_bwd_dkdv", "flash_bwd_dq")
        assert name == "repro_flash_attention_bwd"
        assert args[12:18] == (b, sq, h, n, sk, e)
        assert args[-3:-1] == kb.plan(b, sq, h, sk, False, 0)


# -- K1 decode attention -----------------------------------------------------

@pytest.mark.parametrize("S,h,n,e,bk", [
    (256, 8, 4, 64, 64),
    (512, 16, 2, 128, 128),
    (128, 4, 4, 64, 128),
])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_decode_plain_matches_pallas(S, h, n, e, bk, dtype):
    rng = np.random.default_rng(12)
    jq, tq = _pair(rng, (3, h, e), dtype)
    jk, tk = _pair(rng, (3, S, n, e), dtype)
    jv, tv = _pair(rng, (3, S, n, e), dtype)
    lengths = np.array([S, S // 2, 7], np.int32)
    want = pl_decode(jq, jk, jv, jnp.asarray(lengths), block_k=bk,
                     interpret=True)
    got = ops.decode_attention(tq, tk, tv, torch.from_numpy(lengths))
    assert got.dtype == DTYPES[dtype][1]
    np.testing.assert_allclose(_f32(got), _f32(want), **_tol(dtype))


@pytest.mark.parametrize("h,n,e", [
    (4, 2, 16),      # reduced qwen3 (the CPU tests' width)
    (16, 8, 128),    # qwen3 embed/rerank/search: g = 2
    (32, 8, 128),    # qwen3-4b chat: g = 4
    (16, 16, 64),    # qwen1.5-0.5b draft: g = 1
])
def test_decode_main_path_heads_match_mha(h, n, e):
    rng = np.random.default_rng(13)
    S = 64
    jq, tq = _pair(rng, (2, h, e), "float32")
    jk, tk = _pair(rng, (2, S, n, e), "float32")
    jv, tv = _pair(rng, (2, S, n, e), "float32")
    lengths = np.array([S, 21], np.int32)
    want = jref.decode_attention_ref(jq, jk, jv, jnp.asarray(lengths))
    got = ops.decode_attention(tq, tk, tv, torch.from_numpy(lengths))
    np.testing.assert_allclose(_f32(got), _f32(want), **_tol("float32"))


def test_decode_length_zero_row_is_zero_like_mha():
    """The port follows ``mha``: a row with no valid key outputs 0.  The
    Pallas kernel's -1e30 sentinel gives that row the mean of V instead
    (a quirk of the reference kernel, pinned here)."""
    rng = np.random.default_rng(14)
    jq, tq = _pair(rng, (2, 4, 16), "float32")
    jk, tk = _pair(rng, (2, 32, 2, 16), "float32")
    jv, tv = _pair(rng, (2, 32, 2, 16), "float32")
    lengths = np.array([9, 0], np.int32)
    got = ops.decode_attention(tq, tk, tv, torch.from_numpy(lengths))
    want = jref.decode_attention_ref(jq, jk, jv, jnp.asarray(lengths))
    np.testing.assert_allclose(_f32(got), _f32(want), **_tol("float32"))
    assert float(got[1].abs().max()) == 0.0
    pallas = np.asarray(pl_decode(jq, jk, jv, jnp.asarray(lengths),
                                  block_k=32, interpret=True))
    mean_v = np.repeat(np.asarray(jv)[1].mean(axis=0), 2, axis=0)
    np.testing.assert_allclose(pallas[1], mean_v, atol=1e-5)


# -- K3 top-k retrieval ------------------------------------------------------

@pytest.mark.parametrize("nq,N,d,k,bq,bn", [
    (16, 1000, 64, 8, 8, 256),
    (8, 512, 128, 16, 8, 128),
    (32, 300, 32, 4, 16, 512),
])
def test_topk_plain_matches_pallas(nq, N, d, k, bq, bn):
    rng = np.random.default_rng(15)
    jq, tq = _pair(rng, (nq, d), "float32")
    jc, tc = _pair(rng, (N, d), "float32")
    wv, wi = pl_topk(jq, jc, k, block_q=bq, block_n=bn, interpret=True)
    gv, gi = ops.topk_retrieval(tq, tc, k)
    assert gi.dtype == torch.int32
    np.testing.assert_allclose(gv.numpy(), np.asarray(wv), atol=1e-4)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))


@pytest.mark.parametrize("k", [4, 131, 256])
def test_topk_ties_and_large_k_match_lax_top_k(k):
    """Duplicate corpus rows tie exactly: the lower index comes first, as in
    jax.lax.top_k; k reaches the vector DB's largest over-fetch."""
    rng = np.random.default_rng(16)
    base = rng.standard_normal((160, 24)).astype(np.float32)
    corpus = np.concatenate([base, base[::-1], base[:64]])
    queries = rng.standard_normal((5, 24)).astype(np.float32)
    wv, wi = jref.topk_retrieval_ref(jnp.asarray(queries),
                                     jnp.asarray(corpus), k)
    gv, gi = ops.topk_retrieval(torch.from_numpy(queries),
                                torch.from_numpy(corpus), k)
    np.testing.assert_allclose(gv.numpy(), np.asarray(wv), atol=1e-4)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))


# -- K4 int8 matmul ----------------------------------------------------------

@pytest.mark.parametrize("M,K,N,bm,bn,bk", [
    (128, 256, 192, 64, 64, 64),
    (64, 64, 64, 64, 64, 64),
    (256, 128, 512, 128, 256, 128),
])
def test_int8_plain_and_quantize_match_pallas(M, K, N, bm, bn, bk):
    rng = np.random.default_rng(17)
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = rng.standard_normal((K, N)).astype(np.float32)
    jxq, jsx = jquantize(jnp.asarray(x), axis=1)
    jwq, jsw = jquantize(jnp.asarray(w), axis=0)
    xq, sx = quantize_int8(torch.from_numpy(x), axis=1)
    wq, sw = quantize_int8(torch.from_numpy(w), axis=0)
    assert xq.dtype == torch.int8 and sx.shape == (M, 1)
    assert sw.shape == (1, N)
    np.testing.assert_array_equal(xq.numpy(), np.asarray(jxq))
    np.testing.assert_array_equal(wq.numpy(), np.asarray(jwq))
    np.testing.assert_array_equal(sx.numpy(), np.asarray(jsx))
    np.testing.assert_array_equal(sw.numpy(), np.asarray(jsw))
    want = pl_int8(jxq, jwq, jsx, jsw, block_m=bm, block_n=bn, block_k=bk,
                   interpret=True)
    got = ops.int8_matmul(xq, wq, sx, sw)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(got), _f32(want), atol=1e-2)
    # the int8 product approximates the f32 one
    dense = x @ w
    rel = np.abs(_f32(got) - dense).mean() / np.abs(dense).mean()
    assert rel < 0.05


def test_int8_plain_sums_exactly():
    """Extreme int8 values over a long K: the float64 route gives the exact
    int32 sums (one f32 rounding, then the scales)."""
    rng = np.random.default_rng(18)
    x = rng.choice([-127, 127, -1, 0, 1], size=(5, 4096)).astype(np.int8)
    w = rng.choice([-127, 127, 3], size=(4096, 7)).astype(np.int8)
    acc = x.astype(np.int64) @ w.astype(np.int64)
    one = torch.ones((5, 1)), torch.ones((1, 7))
    got = ops.int8_matmul(torch.from_numpy(x), torch.from_numpy(w), *one,
                          out_dtype=torch.float32)
    np.testing.assert_array_equal(got.numpy(), acc.astype(np.float32))


# -- K5 SSD intra-chunk ------------------------------------------------------

def _ssd_inputs(rng, b, nc, Q, H, P, N):
    x = rng.standard_normal((b, nc, Q, H, P)).astype(np.float32)
    dt = np.logaddexp(rng.standard_normal((b, nc, Q, H)), 0).astype(
        np.float32)
    B = rng.standard_normal((b, nc, Q, H, N)).astype(np.float32)
    C = rng.standard_normal((b, nc, Q, H, N)).astype(np.float32)
    dA = (-dt * 0.5).astype(np.float32)
    return x, dt, B, C, dA


@pytest.mark.parametrize("b,nc,Q,H,P,N", [
    (2, 3, 32, 4, 16, 8),
    (1, 2, 64, 8, 32, 16),
    (2, 1, 16, 2, 8, 8),
    (1, 1, 1, 4, 16, 8),       # decode: one token
    (1, 2, 77, 4, 16, 8),      # the last prefill chunk of a 333-token prompt
    # the engine's other ragged chunks: a 4-token tail, the last chunks of
    # 700- and 200-token prompts (prefill chunks of 128)
    (1, 1, 4, 4, 16, 8),
    (1, 1, 60, 4, 16, 8),
    (1, 1, 72, 4, 16, 8),
])
def test_ssd_plain_matches_pallas(b, nc, Q, H, P, N):
    arrays = _ssd_inputs(np.random.default_rng(19), b, nc, Q, H, P, N)
    wy, wS = pl_ssd(*map(jnp.asarray, arrays), interpret=True)
    y, S = ops.ssd_chunk(*map(torch.from_numpy, arrays))
    assert y.dtype == torch.float32 and S.shape == (b, nc, H, N, P)
    np.testing.assert_allclose(y.numpy(), np.asarray(wy), atol=2e-4,
                               rtol=2e-4)
    np.testing.assert_allclose(S.numpy(), np.asarray(wS), atol=2e-4,
                               rtol=2e-4)


def test_ssd_plain_reads_a_head_broadcast_view():
    """B/C broadcast from one group to every head as a stride-0 view (what
    ``mamba2_forward`` passes) give what a copy per head gives."""
    x, dt, B, C, dA = _ssd_inputs(np.random.default_rng(20), 1, 2, 24, 4,
                                  8, 8)
    B1, C1 = torch.from_numpy(B[:, :, :, :1]), torch.from_numpy(C[:, :, :, :1])
    Bv, Cv = B1.expand(-1, -1, -1, 4, -1), C1.expand(-1, -1, -1, 4, -1)
    assert Bv.stride(3) == 0
    tx, tdt, tdA = map(torch.from_numpy, (x, dt, dA))
    y, S = ops.ssd_chunk(tx, tdt, Bv, Cv, tdA)
    wy, wS = ops.ssd_chunk(tx, tdt, Bv.contiguous(), Cv.contiguous(), tdA)
    assert torch.equal(y, wy) and torch.equal(S, wS)


def test_ssd_plain_is_finite_at_zamba2_decays():
    """zamba2's strongest decay (A = -16) over a full 256-token chunk: the
    exponent is masked before exp, so nothing overflows to inf or NaN."""
    rng = np.random.default_rng(21)
    x, dt, B, C, _ = _ssd_inputs(rng, 1, 1, 256, 2, 8, 8)
    dA = (dt * -16.0).astype(np.float32)
    y, S = ops.ssd_chunk(*map(torch.from_numpy, (x, dt, B, C, dA)))
    assert bool(y.isfinite().all()) and bool(S.isfinite().all())


# -- host-side plans of the redesigned K2 and K3 (pure Python) ---------------

def test_flash_kernel_is_chosen_by_dtype():
    """bf16 runs the wgmma kernel, f32 the CUDA-core one (wgmma has no
    full-f32 mode); any other type has no kernel."""
    from repro_torch.kernels import flash_attention as k2
    assert k2.kernel_for(torch.bfloat16) == "flash_fwd_wgmma"
    assert k2.kernel_for(torch.float32) == "flash_fwd"
    with pytest.raises(ValueError, match="no kernel"):
        k2.kernel_for(torch.float16)


@pytest.mark.parametrize("b,sq,h,n,kv_len,q_offset,want", [
    # the zamba2 engine: 32 heads, b = 1; a late prefill chunk is split
    (1, 128, 32, 32, 1024, 896, (64, 2, 384, 3)),
    (1, 77, 32, 32, 333, 256, (64, 2, 128, 3)),
    (1, 128, 32, 32, 128, 0, (64, 2, 128, 1)),   # 2 key tiles: no split
    # the RAG path: the GQA group packed into the 64-row tile
    (8, 128, 16, 8, 128, 0, (32, 4, 128, 1)),    # qwen3 embed/rerank, g=2
    (1, 16, 32, 8, 16, 0, (16, 1, 64, 1)),       # qwen3-4b chat, g=4
    (1, 16, 16, 16, 16, 0, (64, 1, 64, 1)),      # qwen1.5-0.5b draft, g=1
])
def test_flash_plan_at_path_shapes(b, sq, h, n, kv_len, q_offset, want):
    from repro_torch.kernels import flash_attention as k2
    plan = k2.plan(b, sq, h, n, kv_len, True, q_offset)
    assert plan == want
    per_tile, mtiles, chunk, nsplit = plan
    assert per_tile * (h // n) <= k2.M_TILE
    assert mtiles * per_tile >= sq > (mtiles - 1) * per_tile
    kend = min(kv_len, q_offset + sq)
    assert chunk % k2.KEY_TILE == 0
    assert (nsplit - 1) * chunk < kend <= nsplit * chunk
    if nsplit > 1:     # split only to fill SMs that would sit idle
        assert b * n * mtiles < k2.SMS
        assert chunk >= k2.MIN_SPLIT_TILES * k2.KEY_TILE


# K1 (b, h, n, S, e, nsplit, heads a block): the RAG path's rows (at most
# 32 cached keys) never split and take a block per query head; the zamba2
# engine's (b = 1, 32 heads of 64, MHA, 64 to 923 keys of a 1024-slot
# cache) split into at most 8 blocks of at least two load steps
DECODE_PLAN_CASES = [
    *[(b, h, n, S, e, 1, 1) for b in (1, 8)
      for h, n, e in ((16, 8, 128), (32, 8, 128), (16, 16, 64))
      for S in (1, 17, 32)],
    (1, 32, 32, 64, 64, 1, 1), (1, 32, 32, 200, 64, 1, 1),
    (1, 32, 32, 333, 64, 1, 1), (1, 32, 32, 512, 64, 2, 1),
    (1, 32, 32, 700, 64, 2, 1), (1, 32, 32, 923, 64, 3, 1),
    (1, 32, 32, 1024, 64, 4, 1),
    (4, 32, 32, 923, 64, 3, 1),    # four engine slots in one call
    (1, 16, 8, 512, 128, 8, 2),    # qwen3, a long cache: g heads together
    (8, 32, 8, 512, 128, 5, 4),
    (2, 128, 8, 100, 64, 1, 16),
]


@pytest.mark.parametrize("b,h,n,S,e,nsplit,heads", DECODE_PLAN_CASES)
def test_decode_plan_at_path_shapes(b, h, n, S, e, nsplit, heads):
    """One cluster of at most 8 split blocks per (b, kv head), covering
    the row, split only while b·n blocks leave SMs idle and into at least
    two load steps; heads a block dividing g; 8 warps only for g = 1."""
    from repro_torch.kernels import decode_attention as k1
    chunk, ns, hb, warps = k1.split_plan(b, h, n, S, e)
    assert (ns, hb) == (nsplit, heads)
    g = h // n
    assert 1 <= ns <= k1.MAX_SPLIT and (g % hb) == 0
    assert (ns - 1) * chunk < S <= ns * chunk
    assert warps == (8 if hb == g == 1 and S > k1.SHORT_ROW else 4)
    if ns > 1:
        step = warps * (32 * 16 // (2 * e)) * (4 if g <= 4 else 2)
        assert chunk >= k1.SPLIT_STEPS * step
        assert b * n * (ns - 1) < k1.TARGET_BLOCKS
    if hb < g:          # a block per query head only on short rows
        assert S <= k1.SHORT_ROW and ns == 1


def test_decode_plan_forced_split_counts_cover_the_row():
    from repro_torch.kernels import decode_attention as k1
    for S in (64, 333, 923):
        for ns in range(1, 9):
            chunk, got, heads, _ = k1.split_plan(1, 32, 32, S, 64, 2, ns)
            assert got == ns and heads == 1
            assert (ns - 1) * chunk < S <= ns * chunk


@pytest.mark.parametrize("M,K,N,want", [
    (128, 2048, 4096, "int8_mm_wgmma"),    # a zamba2 projection
    (512, 512, 512, "int8_mm_wgmma"),      # the bench
    (64, 64, 64, "int8_mm_wgmma"),
    (128, 256, 192, "int8_mm_wgmma"),
    (77, 48, 80, "int8_mm_wgmma"),         # M is free
    (77, 100, 33, "int8_mm"),              # the ragged sweep shape
    (64, 100, 64, "int8_mm"),              # K not a multiple of 16
    (64, 64, 40, "int8_mm"),               # N not a multiple of 16
    (64, 8, 64, "int8_mm"),
])
def test_int8_kernel_is_chosen_by_shape(M, K, N, want):
    """The int8 tensor cores take K and N multiples of 16 (x by TMA,
    w in 16-byte rows); every other shape runs the __dp4a kernel."""
    from repro_torch.kernels import int8_matmul as k4
    assert k4.kernel_for(M, N, K) == want


def test_flash_plan_refuses_groups_wider_than_a_tile():
    from repro_torch.kernels import flash_attention as k2
    with pytest.raises(ValueError, match="packs at most"):
        k2.plan(1, 16, 128, 1, 16, True, 0)


def test_flash_tma_views():
    """A cache prefix view is read in place by the tensor map; a view whose
    strides are not 16-byte multiples is not; an axis of length 1 gets the
    stride a contiguous layout would give it."""
    from repro_torch.kernels import flash_attention as k2
    cache = torch.zeros(2, 64, 8, 128, dtype=torch.bfloat16)
    assert k2.tma_ready(cache[:, :40])
    assert k2.tma_strides(cache[:, :40]) == [64 * 8 * 128, 8 * 128, 128]
    odd = torch.zeros(2, 5, 3, 20, dtype=torch.bfloat16)[..., :16]
    assert not k2.tma_ready(odd)
    one = torch.zeros(1, 1, 4, 64, dtype=torch.bfloat16)
    assert k2.tma_strides(one) == [4 * 64, 4 * 64, 64]


@pytest.mark.parametrize("nq,N,k", [
    (1, 128, 112), (1, 128, 8), (16, 128, 112), (1, 5000, 131),
    (16, 5000, 8), (1, 65536, 8), (1, 65536, 131), (16, 65536, 8),
    (16, 65536, 131), (16, 65536, 256), (40, 4096, 16)])
def test_topk_plan_covers_the_corpus_and_fills_the_card(nq, N, k):
    from repro_torch.kernels import topk_retrieval as k3
    qt, R, rows_per, nsplit, kk, per_lane, sf, stages, mwarps = \
        k3.split_plan(nq, N, k)
    assert qt == min(16, 1 << (nq - 1).bit_length())     # sized to nq
    assert rows_per % R == 0 and sf % (4 * 256) == 0 and sf // R >= 4
    assert (nsplit - 1) * rows_per < N <= nsplit * rows_per
    assert kk == (k if rows_per > k else rows_per)
    assert 32 * per_lane >= k > 16 * per_lane or per_lane == 1
    # one wave of at most TARGET_BLOCKS blocks (two per SM), at least half
    # of that as far as whole tiles, and on a large corpus splits of more
    # than k rows, allow
    least = R
    if N >= k3.LARGE_CORPUS * (k + 1):
        least = R * -(-(k + 1) // R)
    blocks = nsplit * -(-nq // qt)
    assert blocks <= k3.TARGET_BLOCKS * -(-nq // qt)
    assert 2 * blocks >= min(k3.TARGET_BLOCKS, N // least)
    assert stages in (2, 3)
    assert k3.smem_bytes(qt, R, per_lane, rows_per > k, sf, stages) \
        <= k3.SMEM_PER_BLOCK
    assert 1 <= mwarps <= 16
    if rows_per > k:
        assert 32 * mwarps >= nsplit       # a lane per sorted list


def test_topk_plan_at_the_vsearch_shape():
    """The vector DB's search (nq = 1, 128 rows, k = 112): 16 blocks of 8
    rows, a warp per row, no selection in them, then one warp sorting
    the 128 scores, 4 per lane."""
    from repro_torch.kernels import topk_retrieval as k3
    assert k3.split_plan(1, 128, 112) == (1, 8, 8, 16, 8, 4, 8192, 3, 1)


def test_topk_plan_keeps_the_gemm_order_on_large_corpora():
    """nq >= 2 over a large corpus: a thread per row (R = 256), summing in
    the plain product's order; nq = 1 lanes per row as its GEMV."""
    from repro_torch.kernels import topk_retrieval as k3
    assert k3.split_plan(16, 65536, 131)[1] == 256
    assert k3.split_plan(2, 65536, 8)[1] == 256
    assert k3.split_plan(1, 65536, 8)[1] == 32
    assert k3.split_plan(16, 5000, 8)[1] == 16


def test_kernel_libraries_hash_every_included_header(tmp_path, monkeypatch):
    """A library's name hashes its source and every header it includes,
    directly or through another header, so an edit to any rebuilds it."""
    from repro_torch.kernels import _build
    for f in _build.CSRC.iterdir():
        (tmp_path / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    assert [p.name for p in _build.sources("flash_attention")] == [
        "flash_attention.cu", "common.cuh", "hopper.cuh", "mla.cuh"]
    before = _build.lib_path("flash_attention")
    other = _build.lib_path("topk_retrieval")
    (tmp_path / "hopper.cuh").write_text(
        (tmp_path / "hopper.cuh").read_text() + "\n// edit\n")
    assert _build.lib_path("flash_attention") != before
    assert _build.lib_path("topk_retrieval") == other
    # the MLA tile loop is K1's and K2's: an edit rebuilds both
    before = [_build.lib_path(n) for n in ("decode_attention",
                                           "flash_attention")]
    (tmp_path / "mla.cuh").write_text(
        (tmp_path / "mla.cuh").read_text() + "\n// edit\n")
    assert all(_build.lib_path(n) != b for n, b in zip(
        ("decode_attention", "flash_attention"), before))
    assert _build.lib_path("topk_retrieval") == other


def test_ptxas_report_names_each_kernel():
    from repro_torch.kernels import _build
    assert _build.demangle("_ZN12_GLOBAL__N_115flash_fwd_wgmmaILi128EEEv10"
                           "CUtensorMap_st") == "flash_fwd_wgmma<128>"
    assert _build.demangle("_ZN12_GLOBAL__N_19flash_fwdIfLi64EEEvPKT_") \
        == "flash_fwd<f32,64>"
    out = ("ptxas info : Compiling entry function '_ZN12_GLOBAL__N_110topk_"
           "mergeILi4EEEvPKfPKiPfPiii' for 'sm_90a'\n"
           "ptxas info : Function properties for _ZN12_GLOBAL__N_110topk_"
           "mergeILi4EEEvPKfPKiPfPiii\n"
           "    16 bytes stack frame, 8 bytes spill stores, 8 bytes spill "
           "loads\n"
           "ptxas info : Used 96 registers, used 1 barriers\n")
    assert _build.ptxas_report(out) == [
        "topk_merge<4>: Used 96 registers, used 1 barriers, 16 bytes stack "
        "frame, 8 bytes spill stores, 8 bytes spill loads"]


# -- host-side plan of the redesigned K5 (pure Python) ------------------------

from repro_torch.kernels import ssd_chunk as k5  # noqa: E402


@pytest.mark.parametrize("Q,dtype,want", [
    (1, torch.bfloat16, "ssd_decode"), (4, torch.bfloat16, "ssd_decode"),
    (k5.DECODE_MAX_Q, torch.bfloat16, "ssd_decode"),
    (k5.DECODE_MAX_Q + 1, torch.bfloat16, "ssd_chunk_mma"),
    (60, torch.bfloat16, "ssd_chunk_mma"), (128, torch.bfloat16,
                                            "ssd_chunk_mma"),
    (256, torch.bfloat16, "ssd_chunk_mma"),
    (1, torch.float32, "ssd_decode"), (4, torch.float32, "ssd_decode"),
    (k5.DECODE_MAX_Q + 1, torch.float32, "ssd_chunk_fwd"),
    (77, torch.float32, "ssd_chunk_fwd"), (256, torch.float32,
                                           "ssd_chunk_fwd"),
])
def test_ssd_plan_picks_the_kernel_by_length_and_type(Q, dtype, want):
    """Short chunks take the decode kernel in either type; longer bf16
    chunks the tensor-core kernel, longer f32 ones the CUDA-core one."""
    assert k5.plan(1, 1, Q, 64, 64, 64, dtype).kernel == want


def test_ssd_plan_widths_off_the_vector_take_the_cuda_core_kernel():
    """P or N not a multiple of 8 cannot take 16-byte rows; the decode and
    tensor-core kernels refuse such a shape when forced."""
    for Q in (1, 128):
        assert k5.plan(1, 1, Q, 4, 12, 8,
                       torch.bfloat16).kernel == "ssd_chunk_fwd"
    for kernel in ("ssd_decode", "ssd_chunk_mma"):
        with pytest.raises(ValueError):
            k5.plan(1, 1, 4, 4, 12, 8, torch.bfloat16, kernel=kernel)
    with pytest.raises(ValueError):       # tensor cores: bf16 only
        k5.plan(1, 1, 64, 4, 16, 8, torch.float32, kernel="ssd_chunk_mma")
    with pytest.raises(ValueError):       # one scan element per lane
        k5.plan(1, 1, k5.DECODE_LIMIT_Q + 1, 4, 16, 8, torch.float32,
                kernel="ssd_decode")


SSD_PLAN_SHAPES = [
    # the engine's seven shapes and the 300-token prefill's, zamba2 widths
    *[(1, 1, Q, 64, 64, 64) for Q in (1, 4, 60, 64, 72, 77, 128)],
    (1, 2, 256, 64, 64, 64),
    # the tests' shapes, narrow widths
    (2, 3, 32, 4, 16, 8), (1, 2, 64, 8, 32, 16), (2, 1, 16, 2, 8, 8),
    (1, 1, 5, 3, 8, 24),
]


def _ssd_all_plans(b, nc, Q, H, P, N):
    """The plan's own choice in both types, and every kernel forced at the
    shape, ssd_decode with every split count it takes."""
    plans = [k5.plan(b, nc, Q, H, P, N, dt)
             for dt in (torch.bfloat16, torch.float32)]
    plans.append(k5.plan(b, nc, Q, H, P, N, torch.bfloat16,
                         kernel="ssd_chunk_fwd"))
    for splits in k5.mma_slices(Q, P, N):
        plans.append(k5.plan(b, nc, Q, H, P, N, torch.bfloat16,
                             kernel="ssd_chunk_mma", splits=splits))
    if Q <= k5.DECODE_LIMIT_Q:
        for splits in range(1, min(k5.DECODE_SPLITS[-1], N) + 1):
            plans.append(k5.plan(b, nc, Q, H, P, N, torch.float32,
                                 kernel="ssd_decode", splits=splits))
    return plans


def _tiles_once(parts, keys, P):
    """Each key's column ranges tile [0, P) exactly once."""
    cols = {}
    for *key, c0, c1 in parts:
        cols.setdefault(tuple(key), []).append((c0, c1))
    assert sorted(cols) == sorted(keys)
    for ranges in cols.values():
        ranges.sort()
        assert ranges[0][0] == 0 and ranges[-1][1] == P
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))


@pytest.mark.parametrize("b,nc,Q,H,P,N", SSD_PLAN_SHAPES)
def test_ssd_plan_covers_every_cell_once(b, nc, Q, H, P, N):
    """Every (batch, chunk, head) gets each of its y rows and each of its
    S rows, every column of them, from exactly one block, under every plan
    and forced plan."""
    cells = [(bi, ci, h) for bi in range(b) for ci in range(nc)
             for h in range(H)]
    for p in _ssd_all_plans(b, nc, Q, H, P, N):
        ys, ss = k5.work(p, b, nc, Q, H, N, P)
        _tiles_once(ys, [(*c, i) for c in cells for i in range(Q)], P)
        _tiles_once(ss, [(*c, n) for c in cells for n in range(N)], P)


@pytest.mark.parametrize("PT", [1, 2, 4, 8])
@pytest.mark.parametrize("N", [8, 24, 64])
def test_ssd_mma_units_deal_each_stripe_once(PT, N):
    """ssd_chunk_mma's dealing of 16-row units to its 8 warps (the
    kernel's work loop, mirrored by mma_units) gives every y row stripe
    and every S row stripe to exactly one warp, at every chunk length and
    slice width, the longest y stripes first."""
    W = k5.MMA_WARPS
    for Q in range(1, k5.MAX_Q + 1):
        ny, ns = -(-Q // 16), -(-N // 16)
        dealt = k5.mma_units(Q, N, PT)
        assert len(dealt) == W
        assert sorted(u for w in dealt for u in w) == list(range(ny + ns))
        # in dealing order (round r gives warps 0..7, then 7..0), the
        # units' costs never rise: y stripe r costs (2r + 4) steps of
        # scores and products, an S stripe 2 + 3 PT products per 8 keys
        order = sorted((r * W + (W - 1 - w if r & 1 else w), u)
                       for w in range(W) for r, u in enumerate(dealt[w]))
        cost = [(2 * u + 4) * 2 * (4 + 3 * PT) if u < ny
                else (16 * ny // 8) * (2 + 3 * PT) for _, u in order]
        assert cost == sorted(cost, reverse=True), (Q, order)


def test_ssd_plan_spreads_a_decode_step_over_the_card():
    """zamba2's decode step (64 heads) gives every one of the H100's 132
    SMs a block, in one wave, so the 1 MB of S is written from every SM; a
    card with half the SMs gets half the slices."""
    p = k5.plan(1, 1, 1, 64, 64, 64, torch.bfloat16)
    gx, gy, gz = p.grid
    assert p.kernel == "ssd_decode"
    assert 132 <= gx * gy * gz <= k5.DECODE_BLOCKS_PER_SM * 132
    assert p.grid == (64, 8, 1) and p.splits == 8
    assert k5.plan(1, 1, 1, 64, 64, 64, torch.bfloat16,
                   card=(66, k5.H100[1])).splits == 4


def test_ssd_mma_plan_fits_shared_memory_and_fills_the_card():
    """ssd_chunk_mma slices P only as far as a block's 227 KB and the 132
    SMs need: zamba2's 128-token chunk takes two slices (128 blocks), the
    256-token chunks at least two (one slice would need 258 KB); a slice
    that does not fit is refused."""
    sms, smem = k5.H100
    for Q, nc in ((60, 1), (128, 1), (256, 1), (256, 2)):
        p = k5.plan(1, nc, Q, 64, 64, 64, torch.bfloat16)
        assert p.kernel == "ssd_chunk_mma"
        assert k5.mma_smem(Q, 64, 64 // p.splits) <= smem
        assert p.splits == 2 and 64 * nc * p.splits >= sms * 7 // 8, p
    assert k5.mma_smem(256, 64, 64) > smem
    with pytest.raises(ValueError):
        k5.plan(1, 1, 256, 64, 64, 64, torch.bfloat16,
                kernel="ssd_chunk_mma", splits=1)


# -- the MLA mode of K1 and K2 (host side) ------------------------------------

@pytest.mark.parametrize("b,n,rows,keys,want", [
    (1, 1, 128, 923, (32, 29)),     # deepseek decode: 4 blocks of 128 heads
    (1, 1, 128, 64, (32, 2)),
    (1, 1, 128 * 128, 900, (928, 1)),   # a 128-token prefill chunk
    (1, 128, 150, 150, (160, 1)),   # the naive forward, n = h = 128
    (1, 8, 150, 150, (32, 5)),      # the small card check, 8 heads
])
def test_mla_plan_at_path_shapes(b, n, rows, keys, want):
    """Splits of whole key tiles cover the key range, only while the
    b·n·⌈rows/32⌉ blocks leave the card under two a SM."""
    from repro_torch.kernels import flash_attention as k2
    chunk, nsplit = k2.mla_plan(b, n, rows, keys)
    assert (chunk, nsplit) == want
    assert chunk % k2.MLA_KEYS == 0
    assert (nsplit - 1) * chunk < keys <= nsplit * chunk
    blocks = b * n * -(-rows // k2.MLA_ROWS["flash_mla"])
    if nsplit > 1:
        assert blocks * (nsplit - 1) < 2 * k2.SMS
    for forced in (1, 2):
        chunk, got = k2.mla_plan(b, n, rows, keys, forced)
        assert (got - 1) * chunk < keys <= got * chunk


def test_mla_kernel_is_chosen_by_type_widths_and_layout():
    """The tensor cores take the bf16 absorbed form, whose plan targets
    one 64-row block an SM: a 128-token chunk's 256 blocks are not split,
    a 16-token one's 32 are."""
    from repro_torch.kernels import flash_attention as k2
    assert k2.mla_kernel_for(torch.bfloat16, 576) == "flash_mla_mma"
    for args in ((torch.float32, 576), (torch.bfloat16, 192),
                 (torch.float32, 192)):
        assert k2.mla_kernel_for(*args) == "flash_mla"
    assert k2.mla_plan(1, 1, 128 * 128, 900, kernel="flash_mla_mma") == \
        (928, 1)
    assert k2.mla_plan(1, 1, 16 * 128, 400, kernel="flash_mla_mma") == \
        (96, 5)


def test_mla_plan_refuses_more_splits_than_key_tiles():
    from repro_torch.kernels import flash_attention as k2
    with pytest.raises(ValueError, match="splits"):
        k2.mla_plan(1, 1, 128, 64, 3)


def test_mla_bytes_count_a_latent_row_once():
    """The absorbed form reads each 576-wide latent row once (v is its
    first 512 columns); values apart add their own bytes."""
    from repro_torch.kernels import decode_attention as k1
    from repro_torch.kernels import flash_attention as k2
    lat = torch.zeros(1, 1024, 576, dtype=torch.bfloat16)[:, :300, None]
    q = torch.zeros(1, 128, 576, dtype=torch.bfloat16)
    lens = torch.tensor([300], dtype=torch.int32)
    qo = (128 * 576 + 128 * 512) * 2
    assert k2.aliases_keys(lat, lat[..., :512])
    assert k1.mla_bytes_moved(q, lat, lat[..., :512], lens) == \
        qo + 4 + 300 * 576 * 2
    v = torch.zeros(1, 300, 1, 512, dtype=torch.bfloat16)
    assert not k2.aliases_keys(lat, v)
    assert k1.mla_flops(q, v, lens, 300) == 2 * 128 * (576 + 512) * 300
    q2 = torch.zeros(1, 4, 128, 576, dtype=torch.bfloat16)
    assert k2.mla_flops(q2, v, 304, True, 300) == \
        2 * 128 * (576 + 512) * (301 + 302 + 303 + 304)
    assert k2.mla_bytes_moved(q2, lat, lat[..., :512], 300, causal=True,
                              q_offset=296) == \
        4 * 128 * (576 + 512) * 2 + 300 * 576 * 2
    # the naive form's values are a tensor of their own
    qn = torch.zeros(1, 4, 8, 192, dtype=torch.bfloat16)
    kn = torch.zeros(1, 300, 8, 192, dtype=torch.bfloat16)
    vn = torch.zeros(1, 300, 8, 128, dtype=torch.bfloat16)
    assert k2.mla_bytes_moved(qn, kn, vn, 300, causal=False) == \
        4 * 8 * (192 + 128) * 2 + 300 * 8 * (192 + 128) * 2


def test_mla_launch_counts_cover_k1_and_k2():
    ops.reset_launch_counts()
    assert ops.mla_launch_counts() == {"decode_attention": 0,
                                       "flash_attention": 0}


@pytest.mark.parametrize("form", ["decode", "absorbed", "naive"])
def test_mla_wrappers_pass_what_the_entry_points_declare(form, monkeypatch):
    """The MLA wrappers' host side, run on CPU tensors against a stand-in
    library: each call passes as many arguments as its entry point's
    ``argtypes`` declare, with the plan's split count, the kernel choice
    and the scale; the values of the absorbed form are the keys' first
    columns, and values apart from them raise."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import decode_attention as k1
    from repro_torch.kernels import flash_attention as k2
    calls = []

    class Lib:
        def __getattr__(self, name):
            def fn(*args):
                calls.append((name, args))
                return 0
            return fn

    monkeypatch.setattr(_build, "check_cuda", lambda *a: None)
    monkeypatch.setattr(_build, "library", lambda *a: Lib())
    monkeypatch.setattr(_build, "stream_ptr", lambda t: 0)
    bf = torch.bfloat16
    lat = torch.zeros(1, 64, 576, dtype=bf)[:, :40, None]
    if form == "decode":
        q = torch.zeros(1, 128, 576, dtype=bf)
        lens = torch.tensor([40], dtype=torch.int32)
        out = k1.decode_attention(q, lat, lat[..., :512], lens, scale=0.07)
        assert out.shape == (1, 128, 512)
        with pytest.raises(ValueError, match="first columns"):
            k1.decode_attention(q, lat, torch.zeros(1, 40, 1, 512, dtype=bf),
                                lens, scale=0.07)
        name, sig = "repro_decode_mla", k1._SIG
    elif form == "absorbed":
        q = torch.zeros(1, 8, 128, 576, dtype=bf)
        out = k2.flash_attention(q, lat, lat[..., :512], q_offset=32,
                                 scale=0.07)
        assert out.shape == (1, 8, 128, 512)
        with pytest.raises(ValueError, match="first 512"):
            k2.flash_attention(q, lat, torch.zeros(1, 40, 1, 512, dtype=bf),
                               q_offset=32, scale=0.07)
        name, sig = "repro_flash_mla", k2._SIG
    else:
        q, k = (torch.zeros(1, 40, 8, 192) for _ in range(2))
        out = k2.flash_attention(q, k, torch.zeros(1, 40, 8, 128),
                                 scale=0.07)
        assert out.shape == (1, 40, 8, 128)
        name, sig = "repro_flash_mla", k2._SIG
    assert [c[0] for c in calls] == [name]
    args = calls[0][1]
    assert len(args) == len(sig[name])
    assert abs(args[sig[name].index(_build.F)] - 0.07) < 1e-12
    if form == "absorbed":
        assert args[1] == args[2] == lat.data_ptr()      # v is k's view
    # bf16 at q·k 576 runs on the tensor cores (the *_mla_mma kernels)
    assert args[-2] == (0 if form == "naive" else 1)
