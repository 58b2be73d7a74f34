"""K3: fused inner-product scoring + top-k on Hopper — wrapper of
``csrc/topk_retrieval.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/topk_retrieval.py``.  Scores
``queries (nq, d) · corpus (N, d)ᵀ`` in f32 and returns each query's ``k``
best as (values descending, int32 ids), ties to the lower index, without
writing the (nq, N) score matrix.  ``k`` may reach 256: the vector DB's
over-fetch ``kk`` goes up to ``k + 127`` (``rag/vectordb.py``).
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import I, P, require

MAX_K = 256
QUERY_TILE = 16         # kQT
ROW_TILE = 128          # kTN
TARGET_BLOCKS = 264     # two blocks per SM of an H100
_SIG = {"repro_topk_retrieval": [P] * 6 + [I] * 8 + [P]}

launches = _build.LaunchCounter()


def _pow2(x: int) -> int:
    return 1 << max(0, (x - 1).bit_length())


def split_plan(nq: int, N: int, k: int):
    """-> (kp, sort_len, rows_per, nsplit): the running list length (a
    power of two >= k), the per-query sort length, corpus rows per split
    block (a multiple of ROW_TILE) and the number of splits."""
    kp = _pow2(k)
    sort_len = _pow2(kp + ROW_TILE)
    qtiles = -(-nq // QUERY_TILE)
    want = max(1, TARGET_BLOCKS // qtiles)
    tiles = -(-N // ROW_TILE)
    rows_per = ROW_TILE * max(1, -(-tiles // want))
    return kp, sort_len, rows_per, -(-N // rows_per)


def topk_retrieval(queries: torch.Tensor, corpus: torch.Tensor,
                   k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """queries (nq, d), corpus (N, d), both f32 and contiguous ->
    (values (nq, k) f32, ids (nq, k) int32)."""
    _build.check_cuda("topk_retrieval", [queries, corpus])
    require(queries.dim() == 2 and corpus.dim() == 2
            and queries.shape[1] == corpus.shape[1],
            f"topk_retrieval: bad shapes {tuple(queries.shape)} x "
            f"{tuple(corpus.shape)}")
    require(queries.dtype == torch.float32 and corpus.dtype == torch.float32,
            f"topk_retrieval: f32 only, got {queries.dtype}/{corpus.dtype}")
    require(queries.is_contiguous() and corpus.is_contiguous(),
            "topk_retrieval: inputs must be contiguous")
    nq, d = queries.shape
    N = corpus.shape[0]
    require(1 <= k <= min(N, MAX_K),
            f"topk_retrieval: k={k} must be in [1, min(N={N}, {MAX_K})]")
    kp, sort_len, rows_per, nsplit = split_plan(nq, N, k)
    out_v = torch.empty((nq, k), dtype=torch.float32, device=queries.device)
    out_i = torch.empty((nq, k), dtype=torch.int32, device=queries.device)
    if nsplit == 1:
        part_v, part_i = out_v, out_i
    else:
        part_v = torch.empty((nq, nsplit, k), dtype=torch.float32,
                             device=queries.device)
        part_i = torch.empty((nq, nsplit, k), dtype=torch.int32,
                             device=queries.device)
    lib = _build.library("topk_retrieval", _SIG)
    rc = lib.repro_topk_retrieval(
        queries.data_ptr(), corpus.data_ptr(), part_v.data_ptr(),
        part_i.data_ptr(), out_v.data_ptr(), out_i.data_ptr(), nq, N, d, k,
        kp, sort_len, rows_per, nsplit, _build.stream_ptr(queries))
    _build.check(lib, rc, "topk_retrieval")
    launches.add()
    return out_v, out_i


def bytes_moved(queries: torch.Tensor, corpus: torch.Tensor, k: int) -> int:
    """Queries and corpus read once, values and ids written once."""
    return 4 * (queries.numel() + corpus.numel()) + 8 * queries.shape[0] * k


def flops(queries: torch.Tensor, corpus: torch.Tensor) -> int:
    return 2 * queries.shape[0] * corpus.shape[0] * queries.shape[1]
