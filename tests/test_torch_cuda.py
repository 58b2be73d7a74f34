"""The CUDA kernels K1-K3 of the PyTorch port against their plain PyTorch
versions, on an NVIDIA GPU (marked ``cuda``; they skip without one).

This file imports no JAX, so it runs on a machine with only PyTorch and
the CUDA toolkit; ``tests/conftest.py`` imports JAX, so there run

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: f32 2e-5, bf16 2e-2 (the kernels sum in another order and
round probabilities to bf16 at another point than ``mha``), top-k values
1e-4 with ids exactly equal.  TF32 is off for the plain versions' products.
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.kernels import ref  # noqa: E402

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _tol(dtype):
    return dict(atol=2e-2, rtol=2e-2) if dtype == "bfloat16" \
        else dict(atol=2e-5, rtol=2e-5)


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
