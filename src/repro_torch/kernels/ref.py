"""Plain PyTorch versions of the kernels K1–K3: the CPU path, and what
``chip_smoke.py`` holds each CUDA kernel against on the card."""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def decode_attention_ref(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor,
                         lengths: torch.Tensor) -> torch.Tensor:
    """q (b,h,e); caches (b,S,n,e); lengths (b,)."""
    from repro_torch.models.layers import mha
    return mha(q[:, None], k_cache, v_cache, causal=False,
               kv_valid_len=lengths)[:, 0]


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, q_offset: int = 0,
                        kv_len: Optional[int] = None) -> torch.Tensor:
    """q (b,sq,h,e), k/v (b,sk,n,e) GQA; query i sits at q_offset + i."""
    from repro_torch.models.layers import mha
    qpos = torch.arange(q.shape[1], device=q.device) + q_offset
    valid = (None if kv_len is None else
             torch.full((q.shape[0],), kv_len, dtype=torch.int32,
                        device=q.device))
    return mha(q, k, v, causal=causal, q_positions=qpos, kv_valid_len=valid)


def topk_retrieval_ref(queries: torch.Tensor, corpus: torch.Tensor,
                       k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 inner products, values descending, ties to the lower index (a
    stable sort keeps equal scores in index order, as jax.lax.top_k)."""
    s = queries.float() @ corpus.float().T
    vals, idxs = torch.sort(s, dim=1, descending=True, stable=True)
    return vals[:, :k].contiguous(), idxs[:, :k].to(torch.int32)
