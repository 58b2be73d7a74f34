"""In-memory vector database (the FAISS role) — port of
``repro/rag/vectordb.py``: exact inner-product search through the
``topk_retrieval`` kernel (its plain version on the CPU).

The capacity buffer lives on the device and is written in place by
``add``; a search scans the lane-aligned prefix (``_round_n``) and
over-fetches ``kk`` to survive the masking of padding slots, then re-sorts
and maps ids on the host, as the reference does.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.kernels import ops


class VectorDB:
    def __init__(self, dim: int, capacity: int = 65536,
                 dtype: torch.dtype = torch.float32,
                 device: DeviceLike = None):
        self.dim = dim
        self.capacity = capacity
        self._vecs = torch.zeros((capacity, dim), dtype=dtype,
                                 device=resolve_device(device))
        self._n = 0
        self._ids: List[int] = []

    def __len__(self) -> int:
        return self._n

    def add(self, vectors: torch.Tensor, ids: Optional[List[int]] = None):
        """vectors (m, dim), L2-normalised by the caller for cosine."""
        m = vectors.shape[0]
        if self._n + m > self.capacity:
            raise RuntimeError("vector db capacity exceeded")
        self._vecs[self._n:self._n + m] = vectors.to(self._vecs.device,
                                                    self._vecs.dtype)
        self._ids.extend(ids if ids is not None
                         else range(self._n, self._n + m))
        self._n += m

    def search(self, queries: torch.Tensor, k: int
               ) -> Tuple[np.ndarray, np.ndarray]:
        """queries (q, dim) -> (scores (q,k), ids (q,k)).  Exact IP search
        over the valid prefix; empty slots are masked by construction
        (zero vectors score 0; callers use normalised embeddings)."""
        if self._n == 0:
            raise RuntimeError("search on empty db")
        k = min(k, self._n)
        # over-fetch to survive masking of lane-padding slots: up to k+127
        kk = min(self._round_n(), k + (self._round_n() - self._n))
        vals, idxs = ops.topk_retrieval(
            queries.to(self._vecs.device, torch.float32).contiguous(),
            self._vecs[: self._round_n()], kk)
        vals, idxs = vals.cpu().numpy().copy(), idxs.cpu().numpy()
        vals[idxs >= self._n] = -np.inf          # mask padding slots
        order = np.argsort(-vals, axis=1)[:, :k]
        vals = np.take_along_axis(vals, order, axis=1)
        idxs = np.take_along_axis(idxs, order, axis=1)
        ids = np.asarray(self._ids)
        return vals, ids[np.clip(idxs, 0, self._n - 1)]

    def _round_n(self) -> int:
        # keep the scanned prefix lane-aligned (128 rows), as the reference
        return min(self.capacity, -(-self._n // 128) * 128)
