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
one.  The window and cross shapes, where every query sees at least 173
keys, are held tighter in bf16: atol 2e-3, rtol 1e-2.  Over that many
keys the probabilities' rounding averages out, and what is left is the
output's rounding, at most one bf16 step (2^-7 of the value), so a key let
in or left out at a window's edge shows; a narrow window (256 of 4096
slots) makes such a key weigh 1/256 of the output.
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
                                              dtype):
    """K2's MLA mode, naive: MHA (n = h) with q·k 192 wide and values of
    128, the plan's split and a forced one."""
    from repro_torch.kernels import flash_attention as k2
    rng = np.random.default_rng(42)
    q, k = (_dev(rng, (b, sq, h, 192), dtype, cuda) for _ in range(2))
    v = _dev(rng, (b, sq, h, 128), dtype, cuda)
    got = k2.run_mla(q, k, v, causal=causal, scale=MLA_SCALE, nsplit=nsplit)
    want = ref.flash_attention_ref(q, k, v, causal=causal, scale=MLA_SCALE)
    torch.cuda.synchronize()
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
