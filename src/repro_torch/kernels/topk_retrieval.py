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
MAX_QUERY_TILE = 16     # queries per scoring block, at most
ROW_TILES = (8, 16, 32)  # corpus rows per tile; 256 / R lanes score a row
ROW_TILE_SEQ = 256      # one row per thread, summed over d in order
SMS = 132               # streaming multiprocessors of an H100 SXM
TARGET_BLOCKS = 264     # two blocks per SM
MERGE_PER_WARP = 2048   # raw scores one merge warp filters
LARGE_CORPUS = 64       # N / (k + 1) from which every split selects
STAGE_FLOATS = (8192, 4096, 2048)   # corpus floats per ring stage
CAND_BUF = 256          # candidate buffer per query (kBuf)
SMEM_PER_BLOCK = (232448 - 2 * 1024) // 2   # two blocks per SM
_SIG = {"repro_topk_retrieval": [P] * 6 + [I] * 13 + [P]}

launches = _build.LaunchCounter()


def _pow2(x: int) -> int:
    return 1 << max(0, (x - 1).bit_length())


def split_plan(nq: int, N: int, k: int):
    """-> (qt, R, rows_per, nsplit, kk, per_lane, sf, stages, mwarps).

    qt: queries per block, nq's power of two, at most 16.  R: corpus rows
    per tile.  Once the corpus has a ROW_TILE_SEQ-row tile for every SM
    and nq >= 2, one thread per row sums it over d in order, as the plain
    product's GEMM does; otherwise the largest of 8, 16, 32 that gives
    TARGET_BLOCKS tiles (else 8), 256 / R lanes per row with a tree at
    the end, as the plain product's GEMV does at nq = 1; so large scores
    agree with the plain version to the last bits.  rows_per: rows per
    split block, whole tiles, as close to TARGET_BLOCKS blocks (two per
    SM, one wave) as whole tiles allow without a second wave, and on a
    large corpus more than k, so each split hands on its k best (sorted),
    not all its rows.
    kk: entries each split hands on per query.  per_lane: list entries
    per merge lane (32 * per_lane >= k).  sf, stages: corpus floats per
    ring stage and the ring's depth, as large as two blocks per SM leave
    shared memory for.  mwarps: merge warps, one lane per split list when
    the lists are sorted."""
    qt = min(MAX_QUERY_TILE, _pow2(nq))
    qtiles = -(-nq // qt)
    want = max(1, TARGET_BLOCKS // qtiles)
    if nq >= 2 and -(-N // ROW_TILE_SEQ) >= SMS:
        R = ROW_TILE_SEQ
    else:
        R = next((r for r in reversed(ROW_TILES) if -(-N // r) >= want),
                 ROW_TILES[0])
    tiles = -(-N // R)
    per = -(-tiles // want)
    if N >= LARGE_CORPUS * (k + 1):
        per = max(per, -(-(k + 1) // R))
    rows_per = per * R
    nsplit = -(-tiles // per)
    kk = min(k, rows_per)
    per_lane = max(1, _pow2(k) // 32)
    # the largest stages that leave two blocks per SM, then a third stage
    # if it fits: a step's fixed cost (a barrier, the waits) is paid per
    # stage, so fewer, larger stages stream faster than deeper rings
    select = rows_per > k
    sf = next((f for f in STAGE_FLOATS
               if smem_bytes(qt, R, per_lane, select, f, 2) <= SMEM_PER_BLOCK),
              STAGE_FLOATS[-1])
    stages = 3 if smem_bytes(qt, R, per_lane, select, sf, 3) \
        <= SMEM_PER_BLOCK else 2
    if rows_per > k:
        mwarps = -(-nsplit // 32)
    else:
        mwarps = min(8, max(1, -(-(nsplit * kk) // MERGE_PER_WARP)))
    return qt, R, rows_per, nsplit, kk, per_lane, sf, stages, mwarps


def smem_bytes(qt: int, R: int, per_lane: int, select: bool, sf: int,
               stages: int) -> int:
    """Dynamic shared memory of ``topk_partial`` (as its launch computes
    it): the ring, and the lists, buffers, counts and thresholds of a
    selecting block."""
    dc = sf // R
    ring = 4 * stages * (R * (dc + 4) + qt * dc)
    lists = 4 * qt * (2 * 32 * per_lane + 2 * CAND_BUF + 3) if select else 0
    return ring + lists


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
    require(d % 4 == 0 and queries.data_ptr() % 16 == 0
            and corpus.data_ptr() % 16 == 0,
            f"topk_retrieval: d={d} must be a multiple of 4 and the rows "
            f"16-byte aligned (16-byte copies)")
    qt, R, rows_per, nsplit, kk, per_lane, sf, stages, mwarps = \
        split_plan(nq, N, k)
    dev = queries.device
    out_v = torch.empty((nq, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((nq, k), dtype=torch.int32, device=dev)
    part_v = torch.empty((nq, nsplit, kk), dtype=torch.float32, device=dev)
    part_i = torch.empty((nq, nsplit, kk), dtype=torch.int32, device=dev)
    lib = _build.library("topk_retrieval", _SIG)
    rc = lib.repro_topk_retrieval(
        queries.data_ptr(), corpus.data_ptr(), part_v.data_ptr(),
        part_i.data_ptr(), out_v.data_ptr(), out_i.data_ptr(), nq, N, d, k,
        qt, R, rows_per, nsplit, kk, per_lane, sf, stages, mwarps,
        _build.stream_ptr(queries))
    _build.check(lib, rc, "topk_retrieval")
    launches.add()
    return out_v, out_i


def bytes_moved(queries: torch.Tensor, corpus: torch.Tensor, k: int) -> int:
    """Queries and corpus read once, values and ids written once."""
    return 4 * (queries.numel() + corpus.numel()) + 8 * queries.shape[0] * k


def flops(queries: torch.Tensor, corpus: torch.Tensor) -> int:
    return 2 * queries.shape[0] * corpus.shape[0] * queries.shape[1]
