"""Kernels K1-K3 of the PyTorch port.

On the CPU: the plain PyTorch versions (``repro_torch.kernels.ref``, what
the wrappers run for a CPU tensor) against the Pallas TPU kernels run in
interpret mode, on the sweeps of ``tests/test_kernels.py``, and against
the JAX ``mha`` where the port's kernels go beyond the Pallas ones
(``q_offset``/``kv_len``, a length-0 decode row).  Tolerances: f32 2e-5,
bf16 2e-2, top-k values 1e-4 with ids exactly equal.

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
from repro.kernels.topk_retrieval import topk_retrieval as pl_topk  # noqa: E402
from repro.models.layers import mha as jmha  # noqa: E402
from repro_torch.bridge import to_torch  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

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
