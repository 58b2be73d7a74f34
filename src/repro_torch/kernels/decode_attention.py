"""K1: GQA flash-decode on Hopper — wrapper of ``csrc/decode_attention.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/decode_attention.py``.  One
new query token per sequence attends over the first ``lengths[b]``
positions of a ``(b, S, n, e)`` cache, read in place through its strides
(a prefix view ``cache[:, :L]`` costs nothing).  A row of length 0 outputs
0, as the reference ``mha`` does.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import I, L, P, require

HEAD_DIMS = (16, 64, 128)
MAX_GROUP = 16          # query heads per kv head (kMaxG)
BLOCK_K = 32            # keys per tile (kBK)
TARGET_BLOCKS = 264     # two blocks per SM of an H100
_SIG = {"repro_decode_attention": [P] * 7 + [I] * 8 + [L] * 6 + [P]}

launches = _build.LaunchCounter()


def split_plan(b: int, n: int, S: int):
    """-> (chunk, nsplit): keys per split block (a multiple of BLOCK_K) and
    the number of splits, so b * n * nsplit covers the SMs."""
    tiles = -(-S // BLOCK_K)
    want = max(1, -(-TARGET_BLOCKS // (b * n)))
    chunk = BLOCK_K * max(1, -(-tiles // want))
    return chunk, -(-S // chunk)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor,
                     lengths: torch.Tensor) -> torch.Tensor:
    """q (b, h, e); k/v_cache (b, S, n, e); lengths (b,) int32 -> (b, h, e)
    in q's dtype."""
    _build.check_cuda("decode_attention", [q, k_cache, v_cache, lengths])
    require(q.dim() == 3 and k_cache.dim() == 4
            and v_cache.shape == k_cache.shape,
            f"decode_attention: bad shapes q {tuple(q.shape)}, "
            f"k {tuple(k_cache.shape)}, v {tuple(v_cache.shape)}")
    b, h, e = q.shape
    kb, S, n, ke = k_cache.shape
    require(kb == b and ke == e and S >= 1,
            f"decode_attention: q {tuple(q.shape)} vs cache "
            f"{tuple(k_cache.shape)}")
    require(h % n == 0 and h // n <= MAX_GROUP,
            f"decode_attention: {h} heads over {n} kv heads unsupported")
    require(e in HEAD_DIMS, f"decode_attention: head dim {e} not in "
            f"{HEAD_DIMS}")
    require(q.dtype in _build.DTYPE_CODES and k_cache.dtype == q.dtype
            and v_cache.dtype == q.dtype,
            f"decode_attention: dtypes {q.dtype}/{k_cache.dtype}/"
            f"{v_cache.dtype} unsupported")
    require(q.is_contiguous() and k_cache.stride(-1) == 1
            and v_cache.stride(-1) == 1,
            "decode_attention: q must be contiguous and k/v unit-stride "
            "on the head dim")
    require(lengths.shape == (b,) and lengths.dtype == torch.int32
            and lengths.is_contiguous(),
            "decode_attention: lengths must be a contiguous (b,) int32")
    g = h // n
    chunk, nsplit = split_plan(b, n, S)
    out = torch.empty_like(q)
    part_o = torch.empty((b, n, nsplit, g, e), dtype=torch.float32,
                         device=q.device)
    part_ml = torch.empty((b, n, nsplit, g, 2), dtype=torch.float32,
                          device=q.device)
    lib = _build.library("decode_attention", _SIG)
    rc = lib.repro_decode_attention(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        lengths.data_ptr(), part_o.data_ptr(), part_ml.data_ptr(),
        out.data_ptr(), _build.DTYPE_CODES[q.dtype], b, h, n, S, e, chunk,
        nsplit, *k_cache.stride()[:3], *v_cache.stride()[:3],
        _build.stream_ptr(q))
    _build.check(lib, rc, "decode_attention")
    launches.add()
    return out


def bytes_moved(q: torch.Tensor, k_cache: torch.Tensor,
                lengths: torch.Tensor) -> int:
    """Least bytes one call must move: q, the valid K and V rows, the
    lengths and the output, each once."""
    n, e = k_cache.shape[2], k_cache.shape[3]
    valid = int(lengths.clamp(0, k_cache.shape[1]).sum())
    return (2 * q.numel() * q.element_size() + lengths.numel() * 4
            + 2 * valid * n * e * k_cache.element_size())


def flops(q: torch.Tensor, lengths: torch.Tensor, S: int) -> int:
    """QK and PV multiply-adds over the valid keys (2 flops each)."""
    h, e = q.shape[1], q.shape[2]
    return 4 * h * e * int(lengths.clamp(0, S).sum())
