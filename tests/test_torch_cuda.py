"""The CUDA kernels K1-K5 of the PyTorch port against their plain PyTorch
versions, on an NVIDIA GPU (marked ``cuda``; they skip without one).

This file imports no JAX, so it runs on a machine with only PyTorch and
the CUDA toolkit; ``tests/conftest.py`` imports JAX, so there run

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: f32 2e-5, bf16 2e-2 (the kernels sum in another order and
round probabilities to bf16 at another point than ``mha``; K1 runs every
template and cluster size), top-k values 1e-4 with ids exactly equal (on
random data over every split plan, ids may differ only inside
near-ties, exact scores within 1e-5: the kernel sums in another order
than the plain product), the int8 product exactly equal
(``int8_mm_wgmma`` where K and N are multiples of 16, else ``int8_mm``),
the SSD chunk 2e-4 (f32 outputs from sums of up to 256 products in
another order).  TF32 is off for the plain versions' products.  bf16
attention runs the wgmma kernel (``flash_fwd_wgmma``), f32 the CUDA-core
one, and so does its backward (``flash_bwd_dkdv_wgmma`` and
``flash_bwd_dq_wgmma`` in bf16).  The window and cross shapes, where
every query sees at least 173 keys, are held tighter in bf16: atol 2e-3,
rtol 1e-2.  Over that many keys the probabilities' rounding averages out,
and what is left is the output's rounding, at most one bf16 step (2^-7
of the value), so a key let in or left out at a window's edge shows; a
narrow window (256 of 4096 slots) makes such a key weigh 1/256 of the
output.
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.kernels import ref  # noqa: E402

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _tol(dtype):
    return dict(atol=2e-2, rtol=2e-2) if dtype == "bfloat16" \
        else dict(atol=2e-5, rtol=2e-5)


def _wide_tol(dtype):
    """Calls whose every query sees at least 173 keys (module docstring)."""
    return dict(atol=2e-3, rtol=1e-2) if dtype == "bfloat16" \
        else _tol(dtype)


def _f32(t):
    return t.float().cpu().numpy()


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    return torch.device("cuda")


def _dev(rng, shape, dtype, device):
    return torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(device, DTYPES[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("h,n,e", [(4, 2, 16), (16, 8, 128), (32, 8, 128),
                                   (16, 16, 64)])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_decode_kernel_matches_plain(cuda, h, n, e, dtype):
    from repro_torch.kernels import decode_attention as k1
    rng = np.random.default_rng(20)
    S, b = 300, 3
    q = _dev(rng, (b, h, e), dtype, cuda)
    kc, vc = _dev(rng, (b, S, n, e), dtype, cuda), \
        _dev(rng, (b, S, n, e), dtype, cuda)
    lengths = torch.tensor([S, 77, 0], dtype=torch.int32, device=cuda)
    got = k1.decode_attention(q, kc, vc, lengths)
    want = ref.decode_attention_ref(q, kc, vc, lengths)
    torch.cuda.synchronize()
    np.testing.assert_allclose(_f32(got), _f32(want), **_tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("g", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("e", [16, 64, 128])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_decode_kernel_every_group_and_head_dim(cuda, g, e, dtype):
    """Every template of decode_attn (g query heads per kv head, head dim
    e), one split and an 8-block cluster, ragged rows."""
    from repro_torch.kernels import decode_attention as k1
    rng = np.random.default_rng(28)
    b, n, S = 2, 2, 200
    q = _dev(rng, (b, g * n, e), dtype, cuda)
    kc, vc = (_dev(rng, (b, S, n, e), dtype, cuda) for _ in range(2))
    lengths = torch.tensor([S, 61], dtype=torch.int32, device=cuda)
    want = ref.decode_attention_ref(q, kc, vc, lengths)
    for nsplit in (1, 8):
        got = k1.run(q, kc, vc, lengths, nsplit)
        torch.cuda.synchronize()
        np.testing.assert_allclose(_f32(got), _f32(want), **_tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("nsplit", range(1, 9))
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_decode_kernel_every_split_count(cuda, nsplit, dtype):
    """The zamba2 engine's heads (32 of 64, g = 1) over a 1024-slot cache
    read as its prefix (a batch stride that is not S·n·e), every cluster
    size, ragged rows with a 0-length one inside the cluster."""
    from repro_torch.kernels import decode_attention as k1
    rng = np.random.default_rng(29)
    S = 923
    q = _dev(rng, (3, 32, 64), dtype, cuda)
    kc, vc = (_dev(rng, (3, 1024, 32, 64), dtype, cuda)[:, :S]
              for _ in range(2))
    lengths = torch.tensor([S, 0, 130], dtype=torch.int32, device=cuda)
    got = k1.run(q, kc, vc, lengths, nsplit)
    want = ref.decode_attention_ref(q, kc, vc, lengths)
    torch.cuda.synchronize()
    np.testing.assert_allclose(_f32(got), _f32(want), **_tol(dtype))
    assert float(got[1].float().abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,n,S,e", [
    # the RAG path's short rows: a block per query head
    (1, 16, 8, 32, 128), (1, 32, 8, 17, 128), (8, 32, 8, 32, 128),
    (1, 16, 16, 32, 64), (2, 64, 4, 48, 128),
    # the zamba2 engine: 32 heads of 64, the plan's split count
    *[(1, 32, 32, S, 64) for S in (1, 64, 333, 512, 923)],
    (1, 16, 8, 512, 128)])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_decode_kernel_at_the_planned_split(cuda, b, h, n, S, e, dtype):
    """decode_attention as the layers call it, on the valid prefix of a
    1024-slot cache, with split_plan's heads, splits and warps."""
    from repro_torch.kernels import decode_attention as k1
    rng = np.random.default_rng(30)
    q = _dev(rng, (b, h, e), dtype, cuda)
    kc, vc = (_dev(rng, (b, 1024, n, e), dtype, cuda)[:, :S]
              for _ in range(2))
    lengths = torch.full((b,), S, dtype=torch.int32, device=cuda)
    got = k1.decode_attention(q, kc, vc, lengths)
    want = ref.decode_attention_ref(q, kc, vc, lengths)
    torch.cuda.synchronize()
    np.testing.assert_allclose(_f32(got), _f32(want), **_tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("sq,sk,q_offset,causal", [
    (128, 128, 0, True), (16, 48, 32, True), (192, 192, 0, True),
    (70, 100, 0, False)])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_flash_kernel_matches_plain(cuda, sq, sk, q_offset, causal, dtype):
    from repro_torch.kernels import flash_attention as k2
    rng = np.random.default_rng(21)
    q = _dev(rng, (2, sq, 16, 128), dtype, cuda)
    k, v = _dev(rng, (2, sk, 8, 128), dtype, cuda), \
        _dev(rng, (2, sk, 8, 128), dtype, cuda)
    got = k2.flash_attention(q, k, v, causal=causal, q_offset=q_offset)
    want = ref.flash_attention_ref(q, k, v, causal=causal,
                                   q_offset=q_offset)
    torch.cuda.synchronize()
    np.testing.assert_allclose(_f32(got), _f32(want), **_tol(dtype))


# bf16 runs flash_fwd_wgmma: (b, sq, h, n, sk, e, q_offset, kv_len, causal)
WGMMA_CASES = [
    # every head dim with GQA groups of 1, 2 and 4 (h = 8g, n = 8); sq not
    # a multiple of 64, causal and not
    *[(2, 77, 8 * g, 8, 77, e, 0, None, True)
      for e in (16, 64, 128) for g in (1, 2, 4)],
    *[(1, 72, 8 * g, 8, 100, e, 0, None, False)
      for e in (16, 64, 128) for g in (1, 2, 4)],
    (2, 60, 16, 8, 60, 128, 0, None, True),     # qwen3 embed/rerank, g = 2
    (1, 16, 32, 8, 16, 128, 0, None, True),     # qwen3-4b chat prefill
    (2, 192, 16, 8, 192, 128, 0, None, True),
    (1, 16, 16, 16, 16, 64, 0, None, True),     # qwen1.5-0.5b draft
    # the zamba2 engine: 32 heads of 64, MHA, b = 1, chunked prefill into a
    # 1024-slot cache (key range split across blocks, then combined)
    (1, 128, 32, 32, 128, 64, 0, None, True),
    (1, 77, 32, 32, 333, 64, 256, None, True),
    (1, 128, 32, 32, 1024, 64, 896, None, True),
    (1, 60, 32, 32, 700, 64, 640, None, True),
    # kv_len < sk; kv_len 0 (every row fully masked: outputs 0)
    (2, 16, 8, 4, 64, 64, 24, 40, True),
    (1, 8, 8, 4, 32, 128, 0, 0, False),
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,h,n,sk,e,q_offset,kv_len,causal",
                         WGMMA_CASES)
def test_flash_wgmma_kernel_matches_plain(cuda, b, sq, h, n, sk, e, q_offset,
                                          kv_len, causal):
    """bf16 through flash_fwd_wgmma, k/v read in place as the prefix of a
    longer cache (as ``layers.attention`` passes them)."""
    from repro_torch.kernels import flash_attention as k2
    rng = np.random.default_rng(25)
    q = _dev(rng, (b, sq, h, e), "bfloat16", cuda)
    kc, vc = (_dev(rng, (b, sk + 64, n, e), "bfloat16", cuda)
              for _ in range(2))
    k, v = kc[:, :sk], vc[:, :sk]
    assert k2.kernel_for(q.dtype) == "flash_fwd_wgmma"
    got = k2.flash_attention(q, k, v, causal=causal, q_offset=q_offset,
                             kv_len=kv_len)
    want = ref.flash_attention_ref(q, k, v, causal=causal,
                                   q_offset=q_offset, kv_len=kv_len)
    torch.cuda.synchronize()
    np.testing.assert_allclose(_f32(got), _f32(want), **_tol("bfloat16"))
    if kv_len == 0:
        assert float(got.float().abs().max()) == 0.0


def _near_tie_ids(q, c, gi, wi):
    """Ids may differ only where the two entries' exact scores (float64)
    lie within 1e-5: the kernel sums in another order than the plain
    product."""
    diff = gi != wi
    if bool(diff.any()):
        s = q.double() @ c.double().T
        gap = (s.gather(1, gi.long()) - s.gather(1, wi.long())).abs()[diff]
        assert float(gap.max()) <= 1e-5, f"ids differ by {gap.max()}"
    assert all(len(set(r)) == len(r) for r in gi.tolist()), "duplicate ids"


@pytest.mark.cuda
@pytest.mark.parametrize("nq,N,k", [
    (nq, N, k) for nq in (1, 16) for N in (128, 5000, 65536)
    for k in (8, 112, 131, 256) if k <= N])
def test_topk_kernel_every_plan(cuda, nq, N, k):
    """Every split plan the path and the check shapes give (one row per
    warp at N = 128, selection with a threshold past k rows per split),
    d = 1024; values to 1e-4, ids equal up to near-ties."""
    from repro_torch.kernels import topk_retrieval as k3
    rng = np.random.default_rng(26)
    q = _dev(rng, (nq, 1024), "float32", cuda)
    c = _dev(rng, (N, 1024), "float32", cuda)
    gv, gi = k3.topk_retrieval(q, c, k)
    wv, wi = ref.topk_retrieval_ref(q, c, k)
    torch.cuda.synchronize()
    np.testing.assert_allclose(gv.cpu().numpy(), wv.cpu().numpy(), atol=1e-4)
    _near_tie_ids(q, c, gi, wi)


@pytest.mark.cuda
@pytest.mark.parametrize("nq,N,k", [(1, 128, 112), (16, 5000, 8),
                                    (8, 4096, 256), (16, 65536, 131)])
def test_topk_kernel_exact_scores_ids_equal(cuda, nq, N, k):
    """Multiples of 1/8 with |x| <= 2/8 make every score exact in f32 in
    any order of summation, so ties are true ties and the ids must equal
    the plain version's (ties to the lower index)."""
    from repro_torch.kernels import topk_retrieval as k3
    rng = np.random.default_rng(27)
    ints = rng.integers(-2, 3, (nq + N, 64)).astype(np.float32) / 8
    x = torch.from_numpy(ints).to(cuda)
    q, c = x[:nq].contiguous(), x[nq:].contiguous()
    gv, gi = k3.topk_retrieval(q, c, k)
    wv, wi = ref.topk_retrieval_ref(q, c, k)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(gv.cpu().numpy(), wv.cpu().numpy())
    np.testing.assert_array_equal(gi.cpu().numpy(), wi.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("nq,N,d,k", [(1, 128, 1024, 112), (16, 5000, 64, 8),
                                      (16, 65536, 1024, 131)])
def test_topk_kernel_matches_plain(cuda, nq, N, d, k):
    from repro_torch.kernels import topk_retrieval as k3
    rng = np.random.default_rng(22)
    q = _dev(rng, (nq, d), "float32", cuda)
    c = _dev(rng, (N, d), "float32", cuda)
    gv, gi = k3.topk_retrieval(q, c, k)
    wv, wi = ref.topk_retrieval_ref(q, c, k)
    torch.cuda.synchronize()
    np.testing.assert_allclose(gv.cpu().numpy(), wv.cpu().numpy(), atol=1e-4)
    np.testing.assert_array_equal(gi.cpu().numpy(), wi.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N", [(128, 256, 192), (64, 64, 64),
                                   (256, 128, 512), (512, 512, 512),
                                   (128, 2048, 4096), (77, 100, 33)])
@pytest.mark.parametrize("out_dtype", sorted(DTYPES))
def test_int8_kernel_matches_plain_exactly(cuda, M, K, N, out_dtype):
    from repro_torch.kernels import int8_matmul as k4
    rng = np.random.default_rng(23)
    x = _dev(rng, (M, K), "float32", cuda)
    w = _dev(rng, (K, N), "float32", cuda)
    xq, sx = k4.quantize_int8(x, axis=1)
    wq, sw = k4.quantize_int8(w, axis=0)
    got = k4.int8_matmul(xq, wq, sx, sw, DTYPES[out_dtype])
    want = ref.int8_matmul_ref(xq, wq, sx, sw, DTYPES[out_dtype])
    torch.cuda.synchronize()
    np.testing.assert_array_equal(_f32(got), _f32(want))


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N", [(128, 2048, 4096), (512, 512, 512),
                                   (64, 64, 64), (77, 100, 33)])
@pytest.mark.parametrize("out_dtype", sorted(DTYPES))
def test_int8_kernel_by_shape_from_unaligned_views(cuda, M, K, N,
                                                   out_dtype):
    """Each kernel_for choice (int8_mm_wgmma, or int8_mm for the ragged
    shape) exactly equal to the plain version, with x and w handed over
    as contiguous views 1 byte past a 16-byte boundary."""
    from repro_torch.kernels import int8_matmul as k4
    rng = np.random.default_rng(31)
    xq, sx = k4.quantize_int8(_dev(rng, (M, K), "float32", cuda), axis=1)
    wq, sw = k4.quantize_int8(_dev(rng, (K, N), "float32", cuda), axis=0)
    x_buf = torch.empty(M * K + 1, dtype=torch.int8, device=cuda)
    w_buf = torch.empty(K * N + 1, dtype=torch.int8, device=cuda)
    x_view, w_view = x_buf[1:].view(M, K), w_buf[1:].view(K, N)
    x_view.copy_(xq)
    w_view.copy_(wq)
    assert x_view.data_ptr() % 16 == 1
    got = k4.int8_matmul(x_view, w_view, sx, sw, DTYPES[out_dtype])
    want = ref.int8_matmul_ref(xq, wq, sx, sw, DTYPES[out_dtype])
    torch.cuda.synchronize()
    assert k4.kernel_for(M, N, K) == ("int8_mm" if K % 16 else
                                      "int8_mm_wgmma")
    np.testing.assert_array_equal(_f32(got), _f32(want))


def _ssd_inputs(rng, b, nc, Q, H, P, N, dtype, device, groups=None):
    x = _dev(rng, (b, nc, Q, H, P), dtype, device)
    dt = torch.nn.functional.softplus(_dev(rng, (b, nc, Q, H), "float32",
                                           device))
    A = -torch.linspace(1.0, 16.0, H, device=device)
    G = H if groups is None else groups
    B = _dev(rng, (b, nc, Q, G, N), dtype, device)
    C = _dev(rng, (b, nc, Q, G, N), dtype, device)
    if groups == 1:          # one group broadcast to every head, stride 0
        B, C = (t.expand(-1, -1, -1, H, -1) for t in (B, C))
    return x, dt, B, C, dt * A


@pytest.mark.cuda
@pytest.mark.parametrize("b,nc,Q,H,P,N,groups", [
    (2, 3, 32, 4, 16, 8, None), (1, 2, 64, 8, 32, 16, None),
    (2, 1, 16, 2, 8, 8, None),
    # zamba2-1.2b at full width: 64 heads, P = N = 64, one group
    (1, 1, 1, 64, 64, 64, 1), (1, 1, 77, 64, 64, 64, 1),
    (1, 1, 128, 64, 64, 64, 1), (1, 2, 256, 64, 64, 64, 1)])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_ssd_kernel_matches_plain(cuda, b, nc, Q, H, P, N, groups, dtype):
    from repro_torch.kernels import ssd_chunk as k5
    rng = np.random.default_rng(24)
    args = _ssd_inputs(rng, b, nc, Q, H, P, N, dtype, cuda, groups)
    y, S = k5.ssd_chunk(*args)
    wy, wS = ref.ssd_chunk_ref(*args)
    torch.cuda.synchronize()
    np.testing.assert_allclose(_f32(y), _f32(wy), atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(_f32(S), _f32(wS), atol=2e-4, rtol=2e-4)


def _ssd_close(args, kernel=None, splits=None):
    from repro_torch.kernels import ssd_chunk as k5
    y, S = k5.run(*args, kernel=kernel, splits=splits)
    wy, wS = ref.ssd_chunk_ref(*args)
    torch.cuda.synchronize()
    what = f"{kernel} splits={splits}"
    np.testing.assert_allclose(_f32(y), _f32(wy), atol=2e-4, rtol=2e-4,
                               err_msg=what)
    np.testing.assert_allclose(_f32(S), _f32(wS), atol=2e-4, rtol=2e-4,
                               err_msg=what)


def _ssd_kernels(Q, dtype):
    """Every kernel that takes a chunk of Q tokens of ``dtype`` at widths
    that are multiples of 8."""
    from repro_torch.kernels import ssd_chunk as k5
    return ((["ssd_decode"] if Q <= k5.DECODE_LIMIT_Q else [])
            + (["ssd_chunk_mma"] if dtype == "bfloat16" else [])
            + ["ssd_chunk_fwd"])


@pytest.mark.cuda
@pytest.mark.parametrize("Q,nc", [(1, 1), (4, 1), (60, 1), (64, 1), (72, 1),
                                  (77, 1), (128, 1), (256, 2)])
@pytest.mark.parametrize("groups", [1, None])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_ssd_engine_shapes_every_kernel(cuda, Q, nc, groups, dtype):
    """zamba2's widths (64 heads, P = N = 64) at the engine's chunk lengths
    and the 300-token prefill's two chunks of 256: the plan's kernel and
    every kernel forced, with B/C one group broadcast to every head (stride
    0) and one group per head."""
    args = _ssd_inputs(np.random.default_rng(25), 1, nc, Q, 64, 64, 64,
                       dtype, cuda, groups)
    _ssd_close(args)
    for kernel in _ssd_kernels(Q, dtype):
        _ssd_close(args, kernel)


@pytest.mark.cuda
@pytest.mark.parametrize("Q", [1, 2, 3, 4, 5, 7, 8, 9, 16, 17, 24, 31, 32, 33])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_ssd_every_kernel_around_the_threshold(cuda, Q, dtype):
    """Each kernel forced at every chunk length near the plan's threshold
    (DECODE_MAX_Q) and ssd_decode's limit (32), on 64 heads with shared B/C
    and on 6 heads with a group each; ssd_decode with even and uneven
    slices of S's rows."""
    from repro_torch.kernels import ssd_chunk as k5
    rng = np.random.default_rng(26)
    shared = _ssd_inputs(rng, 1, 1, Q, 64, 64, 64, dtype, cuda, 1)
    own = _ssd_inputs(rng, 2, 2, Q, 6, 32, 16, dtype, cuda)
    for args in (shared, own):
        for kernel in _ssd_kernels(Q, dtype):
            _ssd_close(args, kernel)
    if Q <= k5.DECODE_LIMIT_Q:
        for splits in (1, 3, 4, 8):
            _ssd_close(shared, "ssd_decode", splits)
        _ssd_close(own, "ssd_decode", 5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_ssd_strongest_decay_is_finite(cuda, dtype):
    """zamba2's strongest decay (A = -16) on every head over a full
    256-token chunk: cs reaches about -3000, and every kernel still gives
    finite outputs within 2e-4 of the plain version (the mask comes before
    exp)."""
    from repro_torch.kernels import ssd_chunk as k5
    x, dt, B, C, _ = _ssd_inputs(np.random.default_rng(27), 1, 1, 256, 64,
                                 64, 64, dtype, cuda, 1)
    args = (x, dt, B, C, dt * -16.0)
    assert float(torch.cumsum(args[4].double(), 2).min()) < -2000
    for kernel in _ssd_kernels(256, dtype):
        y, S = k5.run(*args, kernel=kernel)
        assert bool(y.isfinite().all()) and bool(S.isfinite().all()), kernel
        _ssd_close(args, kernel)


# -- window mode (the hybrid family's ring cache) and cross shapes -----------

# (W, end, window, h, n, e): zamba2-long's ring (32 heads of 64) not yet
# full, just full, wrapped at three offsets; windows narrower than the
# ring; the reduced f32 model's width; GQA groups of 8 at e = 128
RING_CASES = [
    *[(4096, end, 4096, 32, 32, 64) for end in (300, 4096, 4097, 4608,
                                                 524288)],
    (4096, 6000, 1000, 32, 32, 64),
    (4096, 524288, 256, 32, 32, 64),
    (256, 700, 256, 4, 4, 16),
    (512, 1000, 512, 64, 8, 128),
]


@pytest.mark.cuda
@pytest.mark.parametrize("W,end,window,h,n,e", RING_CASES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_decode_kernel_window_mode_over_a_ring(cuda, W, end, window, h, n, e,
                                               dtype):
    """K1's window mode over a ring, one new token at end - 1, with the
    plan's split and every cluster size, b = 2."""
    from repro_torch.kernels import decode_attention as k1
    rng = np.random.default_rng(31)
    b = 2
    q = _dev(rng, (b, h, e), dtype, cuda)
    kc, vc = (_dev(rng, (b, W, n, e), dtype, cuda) for _ in range(2))
    pos = ref.ring_positions(W, end, cuda)
    qpos = torch.full((b,), end - 1, dtype=torch.int32, device=cuda)
    full = torch.full((b,), W, dtype=torch.int32, device=cuda)
    wm = dict(kv_positions=pos, q_pos=qpos, window=window)
    want = ref.decode_attention_ref(q, kc, vc, full, **wm)
    for nsplit in (None, 1, 3, 8):
        got = k1.run(q, kc, vc, full, nsplit, **wm)
        torch.cuda.synchronize()
        np.testing.assert_allclose(_f32(got), _f32(want),
                                   **_wide_tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("W,end,window,h,n,e", RING_CASES)
@pytest.mark.parametrize("sq", [1, 77, 128])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_flash_kernel_window_mode_over_a_ring(cuda, W, end, window, h, n, e,
                                              sq, dtype):
    """K2's window mode over a ring: a chunk of sq queries ending at end - 1
    (written into the ring before it attends, as the model does), every
    slot tile visited; bf16 runs flash_fwd_wgmma, f32 flash_fwd."""
    from repro_torch.kernels import flash_attention as k2
    if sq > W:
        pytest.skip("a chunk longer than the ring is refused by the model")
    rng = np.random.default_rng(32)
    q = _dev(rng, (1, sq, h, e), dtype, cuda)
    kc, vc = (_dev(rng, (1, W, n, e), dtype, cuda) for _ in range(2))
    wm = dict(causal=True, q_offset=end - sq,
              kv_positions=ref.ring_positions(W, end, cuda), window=window)
    got = k2.flash_attention(q, kc, vc, **wm)
    want = ref.flash_attention_ref(q, kc, vc, **wm)
    torch.cuda.synchronize()
    np.testing.assert_allclose(_f32(got), _f32(want), **_wide_tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_window_mode_in_position_order(cuda, dtype):
    """A window over a cache in position order, slot i at position i (as
    ``layers.attention`` passes a window off the ring): K2 over a valid
    prefix at an offset, K1 at the last position, each query seeing its
    last 130 keys."""
    from repro_torch.kernels import decode_attention as k1
    from repro_torch.kernels import flash_attention as k2
    rng = np.random.default_rng(33)
    q = _dev(rng, (2, 70, 16, 64), dtype, cuda)
    kc, vc = (_dev(rng, (2, 1024, 8, 64), dtype, cuda) for _ in range(2))
    order = torch.arange(1024, dtype=torch.int32, device=cuda)
    kw = dict(causal=True, q_offset=600, kv_len=670, window=130,
              kv_positions=order)
    got = k2.flash_attention(q, kc, vc, **kw)
    want = ref.flash_attention_ref(q, kc, vc, **kw)
    np.testing.assert_allclose(_f32(got), _f32(want), **_tol(dtype))
    lens = torch.full((2,), 670, dtype=torch.int32, device=cuda)
    wm = dict(kv_positions=order, window=130,
              q_pos=torch.full((2,), 669, dtype=torch.int32, device=cuda))
    q1 = q[:, -1].contiguous()
    got = k1.decode_attention(q1, kc, vc, lens, **wm)
    want = ref.decode_attention_ref(q1, kc, vc, lens, **wm)
    torch.cuda.synchronize()
    np.testing.assert_allclose(_f32(got), _f32(want), **_tol(dtype))


# cross-attention: (layers, T, h, n, e) of whisper-large-v3 (1500 frames,
# 20 heads of 64) and llama-3.2-vision (1601 patches, 64 heads over 8 kv
# heads of 128); one layer's slice of the stacked cross cache
CROSS_CASES = [(4, 1500, 20, 20, 64), (2, 1601, 64, 8, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("L,T,h,n,e", CROSS_CASES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_cross_attention_shapes(cuda, L, T, h, n, e, dtype):
    """Cross prefill (K2 non-causal, 16 queries over T keys) and cross
    decode (K1 over all T keys) on layer 1's slice of a stacked (L, b, T,
    n, e) cross cache, b = 2."""
    from repro_torch.kernels import decode_attention as k1
    from repro_torch.kernels import flash_attention as k2
    rng = np.random.default_rng(34)
    kx, vx = (_dev(rng, (L, 2, T, n, e), dtype, cuda) for _ in range(2))
    k, v = kx[1], vx[1]
    q = _dev(rng, (2, 16, h, e), dtype, cuda)
    got = k2.flash_attention(q, k, v, causal=False)
    want = ref.flash_attention_ref(q, k, v, causal=False)
    np.testing.assert_allclose(_f32(got), _f32(want), **_wide_tol(dtype))
    full = torch.full((2,), T, dtype=torch.int32, device=cuda)
    q1 = q[:, 0].contiguous()
    got = k1.decode_attention(q1, k, v, full)
    want = ref.decode_attention_ref(q1, k, v, full)
    torch.cuda.synchronize()
    np.testing.assert_allclose(_f32(got), _f32(want), **_wide_tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_whisper_encoder_shape(cuda, dtype):
    """whisper-large-v3's encoder self-attention: 1500 x 1500, non-causal,
    20 heads of 64."""
    from repro_torch.kernels import flash_attention as k2
    rng = np.random.default_rng(35)
    q, k, v = (_dev(rng, (1, 1500, 20, 64), dtype, cuda) for _ in range(3))
    got = k2.flash_attention(q, k, v, causal=False)
    want = ref.flash_attention_ref(q, k, v, causal=False)
    torch.cuda.synchronize()
    np.testing.assert_allclose(_f32(got), _f32(want), **_wide_tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("arch,layers,max_len,prompt", [
    ("zamba2-1.2b", 7, 40000, 4200),    # the 4096-slot ring wraps
    ("whisper-large-v3", 2, 64, 12),
    ("llama-3.2-vision-90b", 4, 64, 12),
    ("deepseek-v2-236b", 2, 160, 150),  # MLA at its published widths
    ("xlstm-350m", 4, 64, 45)])
def test_reduced_families_card_matches_cpu(cuda, arch, layers, max_len,
                                           prompt):
    """A reduced f32 model with the same weights on the CPU plain path and
    on the kernel path: prefill logits within 1e-4 and 8 greedy ids
    equal; the cross families with xgate at 0.5 and a seeded source;
    deepseek with its published MLA widths (K2's and K1's MLA mode at
    (576, 512) over 8 heads)."""
    import copy

    from repro_torch.configs import get_config, reduced
    from repro_torch.launch.profile_serve import published_mla_config
    from repro_torch.models import build_model
    cfg = (published_mla_config(arch, layers) if arch.startswith("deepseek")
           else reduced(get_config(arch), layers=layers))
    cpu = build_model(cfg, "cpu").init(3)
    for blk in cpu.modules():
        if getattr(blk, "xgate", None) is not None:
            blk.xgate.data.fill_(0.5)
    params = {"cpu": cpu, "cuda": copy.deepcopy(cpu).to(cuda)}
    rng = np.random.default_rng(36)
    toks = rng.integers(3, cfg.vocab_size, (1, prompt))
    extra = {}
    if cfg.family == "audio":
        extra["audio_frames"] = (cfg.encdec.source_positions, cfg.d_model)
    elif cfg.family == "vlm":
        extra["vision_embeds"] = (cfg.vlm.vision_tokens, cfg.vlm.vision_dim)
    extra = {k: rng.standard_normal((1, *s)).astype(np.float32)
             for k, s in extra.items()}
    out = {}
    for dev, p in params.items():
        model = build_model(cfg, dev)
        cache = model.init_cache(1, max_len)
        chunk = 2048 if cfg.family == "hybrid" else prompt
        for c0 in range(0, prompt, chunk):
            batch = {"tokens": torch.from_numpy(toks[:, c0:c0 + chunk]).to(
                dev), **{k: torch.from_numpy(v).to(dev)
                         for k, v in extra.items() if c0 == 0}}
            lg, cache = model.prefill(p, batch, cache)
        ids = [int(torch.argmax(lg[0, -1]))]
        for _ in range(7):
            lg1, cache = model.decode_step(
                p, torch.tensor([[ids[-1]]], device=dev), cache)
            ids.append(int(torch.argmax(lg1[0])))
        out[dev] = (lg.cpu(), ids)
    torch.cuda.synchronize()
    assert float((out["cuda"][0] - out["cpu"][0]).abs().max()) <= 1e-4
    assert out["cuda"][1] == out["cpu"][1]


# ---------------------------------------------------------------------------
# MLA mode (DeepSeek): values narrower than keys, an explicit scale
# ---------------------------------------------------------------------------

MLA_SCALE = 192 ** -0.5          # 1/sqrt(qk_nope + qk_rope)


def _near_exact_close(got, exact, dtype, fewest):
    """The MLA kernels keep their probabilities in f32; deepseek's peaked
    rows make the plain version's own bf16 rounding of the normalised
    probabilities the larger error, so where every row sees at least 128
    keys the kernel is held, tighter, to the plain version computed with
    f64 values (probabilities not rounded): ``_wide_tol``."""
    tol = _wide_tol(dtype) if fewest >= 128 else _tol(dtype)
    np.testing.assert_allclose(_f32(got), exact.cpu().numpy(), **tol)


def _latent(rng, b, S, dtype, device, slots=None):
    """A latent cache (b, slots, 576) read as its S-row prefix, as the
    model passes it: keys (b, S, 1, 576), values their first 512
    columns."""
    lat = _dev(rng, (b, slots or S, 576), dtype, device)[:, :S, None]
    return lat, lat[..., :512]


@pytest.mark.cuda
@pytest.mark.parametrize("S,lengths,nsplit", [
    (923, [923], None), (64, [64], None), (300, [300, 77, 0], None),
    (300, [300, 77, 1], 1), (300, [300, 5, 211], 3)])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_mla_decode_kernel_matches_plain(cuda, S, lengths, nsplit, dtype):
    """K1's MLA mode: 128 heads over one 576-wide latent row per position
    (n = 1), values its first 512 columns, ragged lengths with a 0-length
    row, the plan's split and forced ones."""
    from repro_torch.kernels import decode_attention as k1
    rng = np.random.default_rng(40)
    b = len(lengths)
    q = _dev(rng, (b, 128, 576), dtype, cuda)
    k, v = _latent(rng, b, S, dtype, cuda, slots=1024)
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    got = k1.run_mla(q, k, v, lens, scale=MLA_SCALE, nsplit=nsplit)
    want = ref.decode_attention_ref(q, k, v, lens, scale=MLA_SCALE)
    exact = ref.decode_attention_ref(q, k, v.double(), lens, scale=MLA_SCALE)
    torch.cuda.synchronize()
    assert got.shape == (b, 128, 512)
    np.testing.assert_allclose(_f32(got), _f32(want), **_tol(dtype))
    _near_exact_close(got, exact, dtype, min(lengths))
    if 0 in lengths:
        assert float(got[lengths.index(0)].abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,h,sk,q_offset,causal", [
    (1, 128, 128, 900, 772, True),      # the engine's last chunk
    (1, 77, 128, 333, 256, True),       # a short last chunk
    (2, 16, 8, 40, 24, True),
    (1, 5, 128, 5, 0, True),            # the first chunk, fewer than 64
    (1, 9, 8, 300, 0, False)])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_mla_flash_kernel_absorbed_matches_plain(cuda, b, sq, h, sk,
                                                 q_offset, causal, dtype):
    """K2's MLA mode, absorbed: a chunk of sq queries at q_offset, h heads
    over the latent rows (576, values the first 512), kv_len = q_offset +
    sq, causal (the reference's ``causal & valid``) or not."""
    from repro_torch.kernels import flash_attention as k2
    rng = np.random.default_rng(41)
    q = _dev(rng, (b, sq, h, 576), dtype, cuda)
    k, v = _latent(rng, b, sk, dtype, cuda, slots=1024)
    kv_len = min(sk, q_offset + sq)
    assert k2.mla_kernel_for(q.dtype, 576) == (
        "flash_mla_mma" if dtype == "bfloat16" else "flash_mla")
    got = k2.flash_attention(q, k, v, causal=causal, q_offset=q_offset,
                             kv_len=kv_len, scale=MLA_SCALE)
    want = ref.flash_attention_ref(q, k, v, causal=causal, q_offset=q_offset,
                                   kv_len=kv_len, scale=MLA_SCALE)
    exact = ref.flash_attention_ref(q, k, v.double(), causal=causal,
                                    q_offset=q_offset, kv_len=kv_len,
                                    scale=MLA_SCALE)
    torch.cuda.synchronize()
    assert got.shape == (b, sq, h, 512)
    np.testing.assert_allclose(_f32(got), _f32(want), **_tol(dtype))
    _near_exact_close(got, exact, dtype, q_offset + 1 if causal else kv_len)


@pytest.mark.cuda
@pytest.mark.parametrize("nsplit", [1, 3, 7])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_mla_flash_kernel_absorbed_forced_splits(cuda, nsplit, dtype):
    """Absorbed chunks with the key range forced into 1, 3 and 7 splits
    (folded by flash_mla_combine): bf16 on the tensor cores, f32 on the
    CUDA cores."""
    from repro_torch.kernels import flash_attention as k2
    rng = np.random.default_rng(44)
    q = _dev(rng, (1, 40, 16, 576), dtype, cuda)
    k, v = _latent(rng, 1, 300, dtype, cuda, slots=1024)
    got = k2.run_mla(q, k, v, causal=True, q_offset=260, scale=MLA_SCALE,
                     nsplit=nsplit)
    want = ref.flash_attention_ref(q, k, v, causal=True, q_offset=260,
                                   scale=MLA_SCALE)
    exact = ref.flash_attention_ref(q, k, v.double(), causal=True,
                                    q_offset=260, scale=MLA_SCALE)
    torch.cuda.synchronize()
    np.testing.assert_allclose(_f32(got), _f32(want), **_tol(dtype))
    _near_exact_close(got, exact, dtype, 261)


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,h,causal", [(1, 77, 128, True),
                                           (2, 130, 8, True),
                                           (1, 33, 16, False)])
@pytest.mark.parametrize("nsplit", [None, 2])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_mla_flash_kernel_naive_matches_plain(cuda, b, sq, h, causal, nsplit,
                                              dtype, monkeypatch):
    """DeepSeek's naive form, MHA (n = h) with q·k 192 wide, values of 128
    and the scale, on K2's generic route (flash_fwd_wgmma<192,128> in
    bf16, flash_fwd in f32): the plan's split and a forced one of the key
    range (flash_combine over 128-wide values) where it has two tiles."""
    from repro_torch.kernels import flash_attention as k2
    rng = np.random.default_rng(42)
    q, k = (_dev(rng, (b, sq, h, 192), dtype, cuda) for _ in range(2))
    v = _dev(rng, (b, sq, h, 128), dtype, cuda)
    if nsplit is not None:
        plan = k2.plan

        def forced(*a, **kw):
            per_tile, mtiles, chunk, _ = plan(*a, **kw)
            tiles = -(-sq // k2.KEY_TILE)
            per = -(-tiles // min(nsplit, tiles))
            return per_tile, mtiles, per * k2.KEY_TILE, -(-tiles // per)
        monkeypatch.setattr(k2, "plan", forced)
    before = k2.mla_launches.count
    got = k2.flash_attention(q, k, v, causal=causal, scale=MLA_SCALE)
    want = ref.flash_attention_ref(q, k, v, causal=causal, scale=MLA_SCALE)
    torch.cuda.synchronize()
    assert k2.mla_launches.count == before      # not the MLA mode
    np.testing.assert_allclose(_f32(got), _f32(want), **_tol(dtype))


@pytest.mark.cuda
def test_mla_mode_refuses_other_widths(cuda):
    """Widths outside the MLA pairs raise, in either kernel, as does a
    scale given to the GQA widths; K1 takes only the absorbed pair, and
    the absorbed pair only with the values as the keys' first columns."""
    from repro_torch.kernels import decode_attention as k1
    from repro_torch.kernels import flash_attention as k2
    rng = np.random.default_rng(43)
    lens = torch.full((1,), 8, dtype=torch.int32, device=cuda)
    for ek, ev in ((192, 128), (320, 256), (128, 128)):
        q = _dev(rng, (1, 8, ek), "bfloat16", cuda)
        k = _dev(rng, (1, 8, 1, ek), "bfloat16", cuda)
        v = _dev(rng, (1, 8, 1, ev), "bfloat16", cuda)
        with pytest.raises(ValueError, match="MLA widths"):
            k1.decode_attention(q, k, v, lens, scale=MLA_SCALE)
    for ek, ev in ((320, 256), (576, 128), (128, 128)):
        q = _dev(rng, (1, 8, 8, ek), "bfloat16", cuda)
        k = _dev(rng, (1, 8, 1, ek), "bfloat16", cuda)
        v = _dev(rng, (1, 8, 1, ev), "bfloat16", cuda)
        with pytest.raises(ValueError, match="MLA widths"):
            k2.flash_attention(q, k, v, scale=MLA_SCALE)
    lens = torch.full((1,), 8, dtype=torch.int32, device=cuda)
    k = _dev(rng, (1, 8, 1, 576), "bfloat16", cuda)
    v = _dev(rng, (1, 8, 1, 512), "bfloat16", cuda)     # not k's columns
    with pytest.raises(ValueError, match="first"):
        k1.decode_attention(_dev(rng, (1, 8, 576), "bfloat16", cuda), k, v,
                            lens, scale=MLA_SCALE)
    with pytest.raises(ValueError, match="first 512"):
        k2.flash_attention(_dev(rng, (1, 8, 8, 576), "bfloat16", cuda), k,
                           v, scale=MLA_SCALE)


# -- K2's backward and training ------------------------------------------------

# b, sq, h, sk, n, e, causal, q_offset, kv_len: the sweep of chip_smoke's
# check_backward (the training shape; g 2/4/8 at e 128; whisper's encoder
# and a cross shape, non-causal; kv_len < sk with a ragged sq; e 16), and
# g 3, whose query tiles hold 63 rows (21 positions of 3 heads).  bf16
# runs the wgmma kernels, f32 the CUDA-core ones.
BWD_CASES = [(8, 256, 16, 256, 16, 64, True, 0, None),
             (2, 256, 8, 256, 4, 128, True, 0, None),
             (2, 256, 16, 256, 4, 128, True, 0, None),
             (2, 256, 32, 256, 4, 128, True, 0, None),
             (1, 1500, 20, 1500, 20, 64, False, 0, None),
             (1, 16, 64, 1601, 8, 128, False, 0, None),
             (2, 77, 8, 128, 4, 64, True, 24, 101),
             (2, 40, 4, 40, 2, 16, True, 0, None),
             (2, 50, 12, 70, 4, 64, False, 0, None)]


def _bwd_tol(dtype, want):
    """K2's backward against its plain version (both compute in f32 from
    the same inputs and LSE): atol a share of the gradient's largest
    |value| (2e-5 in f32: sums in another order; 2e-3 in bf16) and rtol
    1e-4 / 1e-2 (bf16: the gradient's one rounding, 2^-8 to 2^-7 of the
    value)."""
    a, r = (2e-3, 1e-2) if dtype == "bfloat16" else (2e-5, 1e-4)
    return dict(atol=a * float(np.abs(want).max()), rtol=r)


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,h,sk,n,e,causal,q_offset,kv_len", BWD_CASES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_flash_backward_kernel_matches_plain(cuda, b, sq, h, sk, n, e,
                                             causal, q_offset, kv_len,
                                             dtype):
    """K2's LSE (atol 1e-4, rtol 1e-5) and its backward from it, against
    the plain versions."""
    from repro_torch.kernels import flash_attention as k2
    from repro_torch.kernels import flash_attention_bwd as kb
    rng = np.random.default_rng(60)
    q, do = (_dev(rng, (b, sq, h, e), dtype, cuda) for _ in range(2))
    k, v = (_dev(rng, (b, sk, n, e), dtype, cuda) for _ in range(2))
    mask = dict(causal=causal, q_offset=q_offset, kv_len=kv_len)
    o, lse = k2.flash_attention(q, k, v, return_lse=True, **mask)
    want_o, want_lse = ref.flash_attention_lse_ref(q, k, v, **mask)
    got = kb.flash_attention_bwd(q, k, v, o, do, lse, **mask)
    want = ref.flash_attention_bwd_ref(q, k, v, o, do, lse, **mask)
    torch.cuda.synchronize()
    np.testing.assert_allclose(_f32(o), _f32(want_o), **_tol(dtype))
    np.testing.assert_allclose(_f32(lse), _f32(want_lse), atol=1e-4,
                               rtol=1e-5)
    for name, g_, w in zip(("dq", "dk", "dv"), got, want):
        assert g_.dtype == DTYPES[dtype] and g_.shape == w.shape
        assert float(g_.float().abs().max()) > 0, name
        np.testing.assert_allclose(_f32(g_), _f32(w),
                                   **_bwd_tol(dtype, _f32(w)), err_msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,h,sk,n,e,causal,q_offset,kv_len",
                         [BWD_CASES[i] for i in (0, 1, 3, 5, 8)])
def test_flash_backward_bf16_runs_are_bit_equal(cuda, b, sq, h, sk, n, e,
                                                causal, q_offset, kv_len):
    """Two bf16 runs of K2's backward (the wgmma kernels) give the same
    bits: at the training shape, at g 2 and g 8 (the dK/dV pass split
    into f32 partials added in order), 16 queries over 1601 keys (dQ's
    keys split 13 ways) and g 3 (63-row query tiles)."""
    from repro_torch.kernels import flash_attention as k2
    from repro_torch.kernels import flash_attention_bwd as kb
    rng = np.random.default_rng(65)
    q, do = (_dev(rng, (b, sq, h, e), "bfloat16", cuda) for _ in range(2))
    k, v = (_dev(rng, (b, sk, n, e), "bfloat16", cuda) for _ in range(2))
    mask = dict(causal=causal, q_offset=q_offset, kv_len=kv_len)
    o, lse = k2.flash_attention(q, k, v, return_lse=True, **mask)
    first = kb.flash_attention_bwd(q, k, v, o, do, lse, **mask)
    second = kb.flash_attention_bwd(q, k, v, o, do, lse, **mask)
    torch.cuda.synchronize()
    for name, a, b_ in zip(("dq", "dk", "dv"), first, second):
        assert float(a.float().abs().max()) > 0, name
        assert torch.equal(a.view(torch.int16), b_.view(torch.int16)), name


@pytest.mark.cuda
def test_flash_backward_wgmma_kernels_are_in_the_table(cuda):
    """The bf16 route's kernels are in K2's backward row of
    ``ops.BACKWARD_KERNELS`` (so chip_smoke's kernel line and the trace's
    symbol table list them), and the built library shows them issuing
    wgmma (HGMMA) and TMA loads (UTMALDG), the f32 route's CUDA-core
    kernels no wgmma."""
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import flash_attention_bwd as kb
    syms = set({row.name: row for row in ops.BACKWARD_KERNELS}[
        "flash_attention_bwd"].symbols)
    wgmma, cores = kb.kernel_for(torch.bfloat16), kb.kernel_for(torch.float32)
    assert set(wgmma) <= syms and set(cores) <= syms
    _build.library("flash_attention_bwd", kb._SIG)
    counts = _build.sass_counts("flash_attention_bwd", ("HGMMA", "UTMALDG"))
    assert {fn.split("<")[0] for fn in counts} == syms
    for fn, c in counts.items():
        if fn.split("<")[0] in wgmma:
            assert c["HGMMA"] > 0 and c["UTMALDG"] > 0, (fn, c)
        else:
            assert c["HGMMA"] == 0, (fn, c)


@pytest.mark.cuda
def test_flash_backward_of_fully_masked_rows_is_zero(cuda):
    """kv_len 0: every row sees no key; the LSE is -inf and every
    gradient 0, as the plain version's."""
    from repro_torch.kernels import flash_attention as k2
    from repro_torch.kernels import flash_attention_bwd as kb
    rng = np.random.default_rng(61)
    q, do = (_dev(rng, (1, 8, 8, 64), "bfloat16", cuda) for _ in range(2))
    k, v = (_dev(rng, (1, 32, 4, 64), "bfloat16", cuda) for _ in range(2))
    o, lse = k2.flash_attention(q, k, v, causal=False, kv_len=0,
                                return_lse=True)
    grads = kb.flash_attention_bwd(q, k, v, o, do, lse, causal=False,
                                   kv_len=0)
    torch.cuda.synchronize()
    assert bool(torch.isneginf(lse).all())
    assert all(float(t.float().abs().max()) == 0 for t in (o, *grads))


@pytest.mark.cuda
def test_flash_attention_fn_gradients_on_the_card(cuda):
    """autograd through ops.flash_attention (FlashAttentionFn: K2 and its
    backward) gives the gradients of the plain forward differentiated by
    autograd on the card, f32."""
    from repro_torch.kernels import flash_attention_bwd as kb
    from repro_torch.kernels import ops
    rng = np.random.default_rng(62)
    q = _dev(rng, (2, 48, 8, 64), "float32", cuda).requires_grad_()
    k, v = (_dev(rng, (2, 48, 4, 64), "float32", cuda).requires_grad_()
            for _ in range(2))
    do = _dev(rng, (2, 48, 8, 64), "float32", cuda)
    before = kb.launches.count
    got = torch.autograd.grad(ops.flash_attention(q, k, v), (q, k, v), do)
    want = torch.autograd.grad(ref.flash_attention_ref(q, k, v), (q, k, v), do)
    torch.cuda.synchronize()
    assert kb.launches.count == before + 1
    for g_, w in zip(got, want):
        np.testing.assert_allclose(_f32(g_), _f32(w),
                                   **_bwd_tol("float32", _f32(w)))


@pytest.mark.cuda
def test_reduced_train_step_card_matches_cpu(cuda):
    """One train step of reduced f32 qwen1.5 on the card (K2 and its
    backward) against the CPU plain path from the same weights: the loss
    within 1e-4 relative, every gradient within 2e-5 + 1e-4·|want|."""
    import copy

    from repro_torch.configs import get_config, reduced
    from repro_torch.models import build_model, lm
    from repro_torch.training.train_loop import value_and_grad
    cfg = reduced(get_config("qwen1.5-0.5b"))
    cpu = build_model(cfg, "cpu").init(3, trainable=True)
    gpu = copy.deepcopy(cpu).to(cuda)
    toks = torch.from_numpy(np.random.default_rng(63).integers(
        0, cfg.vocab_size, (2, 48)))
    out = {}
    for p in (cpu, gpu):
        t = toks.to(p.embed.device)
        out[p.embed.device.type] = value_and_grad(
            lambda m, b: lm.loss_fn(m, cfg, b), p,
            {"tokens": t, "labels": t})
    (lc, _), gc_ = out["cpu"]
    (lg, _), gg = out["cuda"]
    np.testing.assert_allclose(float(lg), float(lc), rtol=1e-4)
    for name, w in gc_.items():
        np.testing.assert_allclose(_f32(gg[name]), _f32(w), atol=2e-5,
                                   rtol=1e-4, err_msg=name)


@pytest.mark.cuda
def test_kernels_without_a_backward_raise_on_the_card(cuda):
    """K1, K3, K4 and K2's window and MLA (absorbed) modes refuse an input
    that requires a gradient under grad mode (their outputs carry none), naming
    the kernel; under no_grad the same calls run.  (K5 carries a gradient:
    test_ssd_chunk_fn_gradients_on_the_card.)"""
    from repro_torch.kernels import ops
    from repro_torch.kernels.int8_matmul import quantize_int8
    rng = np.random.default_rng(64)

    def dev(*shape, grad=True):
        t = _dev(rng, shape, "float32", cuda)
        return t.requires_grad_() if grad else t
    xq, sx = quantize_int8(dev(32, 64, grad=False), axis=1)
    wq, sw = quantize_int8(dev(64, 32, grad=False), axis=0)
    calls = {
        "decode_attention (K1)": lambda: ops.decode_attention(
            dev(1, 4, 64), dev(1, 32, 2, 64), dev(1, 32, 2, 64),
            torch.full((1,), 32, dtype=torch.int32, device=cuda)),
        "flash_attention (K2) in window mode": lambda: ops.flash_attention(
            dev(1, 8, 4, 64), dev(1, 32, 2, 64), dev(1, 32, 2, 64),
            q_offset=24, window=16,
            kv_positions=torch.arange(32, dtype=torch.int32, device=cuda)),
        # the absorbed form (the naive one, 192/128, has a backward)
        "flash_attention (K2) in MLA mode": lambda: (
            lambda lat: ops.flash_attention(
                dev(1, 8, 4, 576), lat, lat[..., :512], q_offset=24,
                scale=192 ** -0.5))(dev(1, 32, 1, 576)),
        "topk_retrieval (K3)": lambda: ops.topk_retrieval(
            dev(2, 64), dev(128, 64, grad=False), 4),
        "int8_matmul (K4)": lambda: ops.int8_matmul(
            xq, wq, sx.requires_grad_(), sw, torch.float32),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match=name.replace(
                "(", r"\(").replace(")", r"\)") + " has no backward"):
            call()
        with torch.no_grad():
            call()
    torch.cuda.synchronize()


# -- DeepSeek's naive MLA form on the generic route, with its backward ---------

# b, sq, h (= n), causal: keys 192, values 128, the scale 1/sqrt(192),
# sk = sq keys from position 0, except at sq 1: there the query is the
# last of 150 positions (q_offset 149).  (One query over one key has P = 1,
# so dS = P ⊙ (dP - D) and with it the exact dq and dk are 0: both
# versions return rounding noise there, nothing to compare.)
NAIVE_CASES = [(2, sq, h, True) for h in (8, 128) for sq in (1, 77, 150, 512)]
NAIVE_CASES.append((2, 150, 8, False))
NAIVE_SK = 150        # the keys a single query sees


def _naive_args(rng, b, sq, h, dtype, device):
    """q, k, v, dO and the mask of a NAIVE_CASES shape."""
    sk = NAIVE_SK if sq == 1 else sq
    q = _dev(rng, (b, sq, h, 192), dtype, device)
    k = _dev(rng, (b, sk, h, 192), dtype, device)
    v = _dev(rng, (b, sk, h, 128), dtype, device)
    do = _dev(rng, (b, sq, h, 128), dtype, device)
    return q, k, v, do, dict(q_offset=sk - sq, scale=MLA_SCALE)


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,h,causal", NAIVE_CASES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_naive_mla_forward_and_backward_match_plain(cuda, b, sq, h, causal,
                                                    dtype):
    """K2's forward with its LSE and K2's backward at (192, 128) with
    DeepSeek's scale (bf16 on flash_fwd_wgmma and the wgmma backward, two
    warpgroups in its dK/dV pass; f32 on the CUDA cores): the output
    within the forward's limit, the LSE within atol 1e-4, rtol 1e-5, and
    dq, dk, dv within the backward's (``_bwd_tol``) of the plain
    versions; no gradient all 0."""
    from repro_torch.kernels import flash_attention as k2
    from repro_torch.kernels import flash_attention_bwd as kb
    rng = np.random.default_rng(66)
    q, k, v, do, mask = _naive_args(rng, b, sq, h, dtype, cuda)
    mask["causal"] = causal
    o, lse = k2.flash_attention(q, k, v, return_lse=True, **mask)
    want_o, want_lse = ref.flash_attention_lse_ref(q, k, v, **mask)
    got = kb.flash_attention_bwd(q, k, v, o, do, lse, **mask)
    want = ref.flash_attention_bwd_ref(q, k, v, o, do, lse, **mask)
    torch.cuda.synchronize()
    assert o.shape == (b, sq, h, 128) and lse.shape == (b, h, sq)
    np.testing.assert_allclose(_f32(o), _f32(want_o), **_tol(dtype))
    np.testing.assert_allclose(_f32(lse), _f32(want_lse), atol=1e-4,
                               rtol=1e-5)
    for name, g_, w in zip(("dq", "dk", "dv"), got, want):
        assert g_.dtype == DTYPES[dtype] and g_.shape == w.shape
        assert float(g_.float().abs().max()) > 0, name
        np.testing.assert_allclose(_f32(g_), _f32(w),
                                   **_bwd_tol(dtype, _f32(w)), err_msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,h,causal", [NAIVE_CASES[i]
                                           for i in (2, 7, 8)])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_naive_mla_backward_runs_are_bit_equal(cuda, b, sq, h, causal,
                                               dtype):
    """Two runs of K2's backward at (192, 128) give the same bits: the two
    dK/dV warpgroups' sums are added in a fixed order, with no float
    atomics."""
    from repro_torch.kernels import flash_attention as k2
    from repro_torch.kernels import flash_attention_bwd as kb
    rng = np.random.default_rng(67)
    q, k, v, do, mask = _naive_args(rng, b, sq, h, dtype, cuda)
    mask["causal"] = causal
    o, lse = k2.flash_attention(q, k, v, return_lse=True, **mask)
    first = kb.flash_attention_bwd(q, k, v, o, do, lse, **mask)
    second = kb.flash_attention_bwd(q, k, v, o, do, lse, **mask)
    torch.cuda.synchronize()
    for name, a, b_ in zip(("dq", "dk", "dv"), first, second):
        assert float(a.float().abs().max()) > 0, name
        assert torch.equal(a.view(torch.uint8), b_.view(torch.uint8)), name


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "deepseek-v3-671b"])
def test_published_mla_train_step_card_matches_cpu(cuda, arch):
    """One train step of a small f32 DeepSeek at its published MLA widths
    (``published_mla_config``: 8 heads, v3's MTP head included) on the
    card, K2 at (192, 128) and its backward once an attention block,
    against the CPU plain path from the same weights: the loss within
    1e-4 relative, every gradient within 2e-5 + 1e-4·|want|."""
    import copy

    from repro_torch.kernels import flash_attention_bwd as kb
    from repro_torch.launch.profile_serve import published_mla_config
    from repro_torch.models import build_model, lm
    from repro_torch.training.train_loop import value_and_grad
    cfg = published_mla_config(arch)
    cpu = build_model(cfg, "cpu").init(3, trainable=True)
    gpu = copy.deepcopy(cpu).to(cuda)
    toks = torch.from_numpy(np.random.default_rng(68).integers(
        0, cfg.vocab_size, (2, 48)))
    out = {}
    before = kb.launches.count
    for p in (cpu, gpu):
        t = toks.to(p.embed.device)
        out[p.embed.device.type] = value_and_grad(
            lambda m, b: lm.loss_fn(m, cfg, b), p,
            {"tokens": t, "labels": t})
    assert kb.launches.count - before == cfg.num_layers + cfg.mtp_depth
    (lc, _), gc_ = out["cpu"]
    (lg, _), gg = out["cuda"]
    np.testing.assert_allclose(float(lg), float(lc), rtol=1e-4)
    for name, w in gc_.items():
        np.testing.assert_allclose(_f32(gg[name]), _f32(w), atol=2e-5,
                                   rtol=1e-4, err_msg=name)


# -- K5's backward (the hybrid family's training) -------------------------------

SSD_NAMES = ("dx", "ddt", "dB", "dC", "ddA")
# (Q, nc) at zamba2's widths (64 heads, P = N = 64, B and C one group
# broadcast to every head, stride 0): one row, a ragged chunk, the train
# shape's chunks of 256, each alone and as two chunks
SSD_BWD_CASES = [(1, 1), (1, 2), (77, 1), (77, 2), (256, 1), (256, 2)]


def _ssd_bwd_args(rng, Q, nc, dtype, device):
    x, dt, B, C, dA = _ssd_inputs(rng, 1, nc, Q, 64, 64, 64, dtype, device, 1)
    dy = _dev(rng, (1, nc, Q, 64, 64), "float32", device)
    dS = _dev(rng, (1, nc, 64, 64, 64), "float32", device)
    return x, dt, B, C, dA, dy, dS


@pytest.mark.cuda
@pytest.mark.parametrize("Q,nc", SSD_BWD_CASES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_ssd_backward_kernel_matches_plain(cuda, Q, nc, dtype):
    """K5's backward against its plain version at zamba2's shapes (A
    down to -16, so cs reaches about -3000 at Q 256): dx, dB and dC (the
    inputs' type, per head) at the input type's backward limit; ddt and
    ddA (f32) against the plain version evaluated in f64 at the f32
    limit; every gradient finite."""
    from repro_torch.kernels import ssd_chunk_bwd as k5b
    args = _ssd_bwd_args(np.random.default_rng(70), Q, nc, dtype, cuda)
    got = k5b.ssd_chunk_bwd(*args)
    want = ref.ssd_chunk_bwd_ref(*args)
    exact = ref.ssd_chunk_bwd_ref(*(t.double() for t in args))
    torch.cuda.synchronize()
    for name, g_, w, e in zip(SSD_NAMES, got, want, exact):
        assert g_.shape == w.shape and g_.dtype == w.dtype, name
        assert bool(g_.isfinite().all()), name
        if name in ("ddt", "ddA"):
            np.testing.assert_allclose(_f32(g_), _f32(e),
                                       **_bwd_tol("float32", _f32(e)),
                                       err_msg=name)
        else:
            assert float(g_.float().abs().max()) > 0, name
            np.testing.assert_allclose(_f32(g_), _f32(w),
                                       **_bwd_tol(dtype, _f32(w)),
                                       err_msg=name)


def _ssd_bwd_close(got, args, dtype):
    """K5's backward held as test_ssd_backward_kernel_matches_plain holds
    it: dx, dB, dC against the plain version at the input type's limit,
    ddt and ddA against the plain version in f64 at f32's, all finite."""
    want = ref.ssd_chunk_bwd_ref(*args)
    exact = ref.ssd_chunk_bwd_ref(*(t.double() for t in args))
    torch.cuda.synchronize()
    for name, g_, w, e in zip(SSD_NAMES, got, want, exact):
        assert g_.shape == w.shape and g_.dtype == w.dtype, name
        assert bool(g_.isfinite().all()), name
        if name in ("ddt", "ddA"):
            np.testing.assert_allclose(_f32(g_), _f32(e),
                                       **_bwd_tol("float32", _f32(e)),
                                       err_msg=name)
        else:
            assert float(g_.float().abs().max()) > 0, name
            np.testing.assert_allclose(_f32(g_), _f32(w),
                                       **_bwd_tol(dtype, _f32(w)),
                                       err_msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("Q,nc", SSD_BWD_CASES)
@pytest.mark.parametrize("kernel", ["ssd_bwd_mma", "ssd_bwd_tiles"])
def test_ssd_backward_each_bf16_route_matches_plain(cuda, Q, nc, kernel):
    """K5's backward in bf16 with each route forced (the tensor-core
    ssd_bwd_keys_mma + ssd_bwd_queries_mma, the CUDA-core ssd_bwd_tiles)
    at zamba2's shapes, held as the plan's route is."""
    from repro_torch.kernels import ssd_chunk_bwd as k5b
    args = _ssd_bwd_args(np.random.default_rng(74), Q, nc, "bfloat16", cuda)
    _ssd_bwd_close(k5b.run(*args, kernel=kernel), args, "bfloat16")


@pytest.mark.cuda
@pytest.mark.parametrize("b,nc,Q,H,P,N,groups", [
    (2, 3, 33, 4, 16, 8, None), (1, 2, 130, 6, 32, 24, None),
    (1, 1, 200, 3, 40, 56, 1), (2, 1, 16, 2, 64, 64, 1)])
def test_ssd_backward_mma_takes_every_width_of_8(cuda, b, nc, Q, H, P, N,
                                                  groups):
    """The tensor-core route at widths below 64 (multiples of 8), ragged
    chunks and a group per head or one group broadcast to every head."""
    from repro_torch.kernels import ssd_chunk_bwd as k5b
    rng = np.random.default_rng(75)
    x, dt, B, C, dA = _ssd_inputs(rng, b, nc, Q, H, P, N, "bfloat16", cuda,
                                  groups)
    args = (x, dt, B, C, dA, _dev(rng, (b, nc, Q, H, P), "float32", cuda),
            _dev(rng, (b, nc, H, N, P), "float32", cuda))
    assert k5b.plan(b, nc, Q, H, P, N, torch.bfloat16,
                    card=k5b._card(cuda)).kernel == "ssd_bwd_mma"
    _ssd_bwd_close(k5b.run(*args, kernel="ssd_bwd_mma"), args, "bfloat16")


@pytest.mark.cuda
def test_ssd_backward_mma_copies_rows_off_16_bytes(cuda):
    """x, B and C views whose rows do not start on 16 bytes (the mma
    route's copies need them to) are copied first, with the same
    gradients."""
    from repro_torch.kernels import ssd_chunk_bwd as k5b
    from repro_torch.kernels.decode_attention import rows_aligned
    rng = np.random.default_rng(76)
    x, dt, B, C, dA, dy, dS = _ssd_bwd_args(rng, 77, 2, "bfloat16", cuda)
    wide = _dev(rng, (1, 2, 77, 64, 72), "bfloat16", cuda)
    wide[..., 1:65] = x
    xv = wide[..., 1:65]
    assert not rows_aligned(xv)
    args = (xv, dt, B, C, dA, dy, dS)
    got = k5b.run(*args, kernel="ssd_bwd_mma")
    again = k5b.run(x, dt, B, C, dA, dy, dS, kernel="ssd_bwd_mma")
    torch.cuda.synchronize()
    for name, a, b_ in zip(SSD_NAMES, got, again):
        assert torch.equal(a, b_), name
    _ssd_bwd_close(got, args, "bfloat16")


@pytest.mark.cuda
@pytest.mark.parametrize("Q,nc", [(77, 1), (256, 2)])
def test_ssd_backward_mma_is_bit_equal_and_counted_once(cuda, Q, nc):
    """Two runs of the tensor-core route give the same bits (no atomics,
    fixed-order sums), and each call counts one launch."""
    from repro_torch.kernels import ssd_chunk_bwd as k5b
    args = _ssd_bwd_args(np.random.default_rng(77), Q, nc, "bfloat16",
                         cuda)
    before = k5b.launches.count
    first = k5b.run(*args, kernel="ssd_bwd_mma")
    assert k5b.launches.count == before + 1
    second = k5b.ssd_chunk_bwd(*args)
    assert k5b.launches.count == before + 2
    torch.cuda.synchronize()
    for name, a, b_ in zip(SSD_NAMES, first, second):
        assert torch.equal(a.view(torch.uint8), b_.view(torch.uint8)), name


@pytest.mark.cuda
def test_ssd_backward_routes_refuse_what_they_do_not_take(cuda):
    """The tensor-core route refuses f32 and widths off multiples of 8; a
    width past 64 raises on either route; no call falls back."""
    from repro_torch.kernels import ssd_chunk_bwd as k5b
    rng = np.random.default_rng(78)
    f32 = _ssd_bwd_args(rng, 33, 1, "float32", cuda)
    with pytest.raises(ValueError, match="ssd_bwd_mma takes bf16"):
        k5b.run(*f32, kernel="ssd_bwd_mma")
    x, dt, B, C, dA = _ssd_inputs(rng, 1, 1, 33, 4, 12, 8, "bfloat16", cuda)
    odd = (x, dt, B, C, dA, _dev(rng, (1, 1, 33, 4, 12), "float32", cuda),
           _dev(rng, (1, 1, 4, 8, 12), "float32", cuda))
    with pytest.raises(ValueError, match="ssd_bwd_mma takes bf16"):
        k5b.run(*odd, kernel="ssd_bwd_mma")
    _ssd_bwd_close(k5b.ssd_chunk_bwd(*odd), odd, "bfloat16")
    x, dt, B, C, dA = _ssd_inputs(rng, 1, 1, 33, 4, 72, 8, "bfloat16", cuda)
    wide = (x, dt, B, C, dA, _dev(rng, (1, 1, 33, 4, 72), "float32", cuda),
            _dev(rng, (1, 1, 4, 8, 72), "float32", cuda))
    for kernel in k5b.KERNEL_IDS:
        with pytest.raises(ValueError, match="head dim"):
            k5b.run(*wide, kernel=kernel)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_ssd_backward_runs_are_bit_equal(cuda, dtype):
    """Two runs of K5's backward at the train shape's chunks give the
    same bits: no atomics, fixed-order sums."""
    from repro_torch.kernels import ssd_chunk_bwd as k5b
    args = _ssd_bwd_args(np.random.default_rng(71), 256, 2, dtype, cuda)
    first, second = k5b.ssd_chunk_bwd(*args), k5b.ssd_chunk_bwd(*args)
    torch.cuda.synchronize()
    for name, a, b_ in zip(SSD_NAMES, first, second):
        assert torch.equal(a.view(torch.uint8), b_.view(torch.uint8)), name


@pytest.mark.cuda
@pytest.mark.parametrize("groups", [1, 2])
def test_ssd_chunk_fn_gradients_on_the_card(cuda, groups):
    """autograd through ops.ssd_chunk (SsdChunkFn: K5 and its backward)
    gives the gradients of the plain forward differentiated by autograd
    on the card, f32, with dt's and A's paths through dA and B, C one
    group (expand) or two (repeat_interleave) whose heads' gradients
    autograd sums."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_chunk_bwd as k5b
    rng = np.random.default_rng(72)
    b, nc, Q, H, P, N = 2, 2, 64, 8, 32, 16
    x = _dev(rng, (b, nc, Q, H, P), "float32", cuda).requires_grad_()
    dt = torch.nn.functional.softplus(_dev(rng, (b, nc, Q, H), "float32",
                                           cuda)).requires_grad_()
    A = (-torch.linspace(1.0, 16.0, H, device=cuda)).requires_grad_()
    Bg, Cg = (_dev(rng, (b, nc, Q, groups, N), "float32",
                   cuda).requires_grad_() for _ in range(2))
    dy = _dev(rng, (b, nc, Q, H, P), "float32", cuda)
    dS = _dev(rng, (b, nc, H, N, P), "float32", cuda)
    leaves = (x, dt, A, Bg, Cg)

    def grads(fn):
        B, C = ((t.expand(-1, -1, -1, H, -1) if groups == 1 else
                 t.repeat_interleave(H // groups, dim=3)) for t in (Bg, Cg))
        return torch.autograd.grad(fn(x, dt, B, C, dt * A), leaves, (dy, dS))
    before = k5b.launches.count
    got = grads(ops.ssd_chunk)
    want = grads(ref.ssd_chunk_ref)
    torch.cuda.synchronize()
    assert k5b.launches.count == before + 1
    for name, g_, w in zip(("x", "dt", "A", "B", "C"), got, want):
        np.testing.assert_allclose(_f32(g_), _f32(w),
                                   **_bwd_tol("float32", _f32(w)),
                                   err_msg=name)


@pytest.mark.cuda
def test_reduced_zamba2_train_step_card_matches_cpu(cuda):
    """One train step of reduced f32 zamba2 (7 layers: a group of 6
    Mamba2 layers, the shared block, a tail layer; 2 x 40 tokens, two
    chunks of 32 with a padded tail) on the card (K5, K2 and their
    backwards) against the CPU plain path from the same weights: the loss
    within 1e-4 relative, every gradient within 2e-5 + 1e-4·|want|; K5's
    backward launched once per layer."""
    import copy

    from repro_torch.configs import get_config, reduced
    from repro_torch.kernels import ops
    from repro_torch.models import build_model, lm
    from repro_torch.training.train_loop import value_and_grad
    cfg = reduced(get_config("zamba2-1.2b"), layers=7)
    cpu = build_model(cfg, "cpu").init(3, trainable=True)
    gpu = copy.deepcopy(cpu).to(cuda)
    toks = torch.from_numpy(np.random.default_rng(73).integers(
        0, cfg.vocab_size, (2, 40)))
    out = {}
    before = ops.backward_launch_counts()["ssd_chunk_bwd"]
    for p in (cpu, gpu):
        t = toks.to(p.embed.device)
        out[p.embed.device.type] = value_and_grad(
            lambda m, b: lm.loss_fn(m, cfg, b), p,
            {"tokens": t, "labels": t})
    assert ops.backward_launch_counts()["ssd_chunk_bwd"] == before + 7
    (lc, _), gc_ = out["cpu"]
    (lg, _), gg = out["cuda"]
    np.testing.assert_allclose(float(lg), float(lc), rtol=1e-4)
    for name, w in gc_.items():
        np.testing.assert_allclose(_f32(gg[name]), _f32(w), atol=2e-5,
                                   rtol=1e-4, err_msg=name)


@pytest.mark.cuda
def test_kernel_bench_row_at_the_train_shape(cuda):
    """One row of ``launch/kernels_bench.py``: K2's training forward at
    the train path's shape, timed beside its plain version and SDPA under
    its bound."""
    from repro_torch.launch import kernels_bench
    key = kernels_bench.PATH_KEYS["train"]["flash_attention"]
    r = kernels_bench.row("flash_attention", "train", key)
    assert r["device_us"] > 0 and r["host_us"] > 0 and r["plain_us"] > 0
    assert r["library_us"] > 0 and r["bound_by"] in ("bytes", "operations")
    assert 0 < r["bound_us"] < r["device_us"]


@pytest.mark.cuda
def test_train_step_counted_on_the_card_equals_meta(cuda):
    """``launch/op_cost.py`` over one reduced qwen1.5 train step (f32, 2 x
    64 tokens): the same FLOPs, bytes and kernel calls on the card as on
    the meta device, and the card's kernel calls its launches."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun
    cfg = reduced(get_config("qwen1.5-0.5b"), d_model=256)
    ops.reset_launch_counts()
    card, _ = dryrun.count_train_step(cfg, 2, 64, cuda)
    torch.cuda.synchronize()
    launched = {**ops.launch_counts(), **ops.backward_launch_counts()}
    meta, _ = dryrun.count_train_step(cfg, 2, 64, "meta")
    assert dict(card.kernels) == dict(meta.kernels) == {
        "flash_attention": launched["flash_attention"],
        "flash_attention_bwd": launched["flash_attention_bwd"]}
    assert card.flops == meta.flops and card.bytes == meta.bytes
