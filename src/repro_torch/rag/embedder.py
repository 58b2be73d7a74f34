"""Embedding + reranking stages — port of ``repro/rag/embedder.py``.

Embedder: mean-pooled final hidden states, L2-normalised.  Reranker:
cross-encoder scoring ``[query SEP chunk]`` pairs with the ``SEP`` row of
the embedding table as the head, on the first position's hidden state.
Attention is causal and masks no pad token (the flash kernel on CUDA);
pads are masked only in the mean-pool, as in the reference.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.rag.tokenizer import SEP


def _pad_batch(token_lists: Sequence[Sequence[int]], pad_to: int,
               vocab: int, device: torch.device) -> torch.Tensor:
    out = np.zeros((len(token_lists), pad_to), np.int64)
    for i, ids in enumerate(token_lists):
        ids = list(ids)[:pad_to]
        out[i, : len(ids)] = np.clip(ids, 0, vocab - 1)
    return torch.from_numpy(out).to(device)


@torch.no_grad()
def hidden_states(params: lm.DenseLM, cfg: ModelConfig,
                  tokens: torch.Tensor) -> torch.Tensor:
    """Final-layer hidden states (pre-logits).  Dense-family models only
    (the paper's embed/rerank models are all dense)."""
    if cfg.family != "dense":
        raise NotImplementedError(cfg.family)
    x = F.embedding(tokens, params.embed)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    x, _ = lm._run_dense_stack(params.blocks, cfg, x, positions, None, None)
    return L.rmsnorm(params.final_norm, x, cfg.norm_eps)


class Embedder:
    def __init__(self, cfg: ModelConfig, params: lm.DenseLM,
                 max_tokens: int = 128):
        self.cfg = cfg
        self.params = params
        self.max_tokens = max_tokens
        self.device = params.embed.device

    @torch.no_grad()
    def embed(self, token_lists: Sequence[Sequence[int]]) -> torch.Tensor:
        """-> (len(token_lists), d) f32 on the model's device."""
        tokens = _pad_batch(token_lists, self.max_tokens, self.cfg.vocab_size,
                            self.device)
        mask = (tokens != 0).float()
        h = hidden_states(self.params, self.cfg, tokens)
        s = (h.float() * mask[..., None]).sum(dim=1)
        emb = s / mask.sum(-1, keepdim=True).clamp_min(1.0)
        return emb / emb.norm(dim=-1, keepdim=True).clamp_min(1e-6)


class Reranker:
    def __init__(self, cfg: ModelConfig, params: lm.DenseLM,
                 max_tokens: int = 192):
        self.cfg = cfg
        self.params = params
        self.max_tokens = max_tokens
        self.device = params.embed.device

    @torch.no_grad()
    def score(self, query_ids: Sequence[int],
              chunk_ids_list: Sequence[Sequence[int]]) -> np.ndarray:
        pairs = [list(query_ids) + [SEP] + list(c) for c in chunk_ids_list]
        tokens = _pad_batch(pairs, self.max_tokens, self.cfg.vocab_size,
                            self.device)
        h = hidden_states(self.params, self.cfg, tokens)
        w = self.params.embed[SEP]          # reuse a row as the head
        return (h[:, 0] @ w).float().cpu().numpy()
