"""Executable agents — port of ``repro/rag/agents.py``: query rewriter,
search planner, context refiner, chat; greedy generation loops over the
model facade (prefill, then one decode step per token against the KV
cache)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import Model, build_model
from repro_torch.models.lm import LM
from repro_torch.rag.tokenizer import EOS


@dataclass
class GenResult:
    token_ids: List[int]
    steps: int


class LMAgent:
    """Greedy decoding agent with prefill + stepwise decode (KV cache).
    Runs on the device its parameters live on.  ``argmax`` takes the first
    maximum, as ``jnp.argmax`` does."""

    def __init__(self, cfg: ModelConfig, params: LM, max_len: int = 512):
        self.cfg = cfg
        self.params = params
        self.max_len = max_len
        self.device = params.embed.device
        self.model: Model = build_model(cfg, self.device)

    def _tokens(self, rows: Sequence[Sequence[int]]) -> torch.Tensor:
        return torch.tensor([list(r) for r in rows], dtype=torch.int64,
                            device=self.device)

    @torch.no_grad()
    def generate(self, prompt_ids: Sequence[int], max_new: int = 32,
                 stop_at_eos: bool = True) -> GenResult:
        cache = self.model.init_cache(1, self.max_len)
        logits, cache = self.model.prefill(
            self.params, {"tokens": self._tokens([prompt_ids])}, cache)
        tok = int(torch.argmax(logits[0, -1]))
        out = [tok]
        for _ in range(max_new - 1):
            if stop_at_eos and tok == EOS:
                break
            logits, cache = self.model.decode_step(
                self.params, self._tokens([[tok]]), cache)
            tok = int(torch.argmax(logits[0]))
            out.append(tok)
        return GenResult(out, len(out))

    @torch.no_grad()
    def generate_batch(self, prompts: Sequence[Sequence[int]],
                       max_new: int = 32) -> List[GenResult]:
        """One batched prefill + stepwise decode over ``len(prompts)``
        streams.  The model applies no padding mask, so ragged prompts are
        LEFT-CROPPED to the shortest length rather than padded.  Tokens stay
        on the device until the end: one host copy per call."""
        B = len(prompts)
        if B == 1:
            return [self.generate(prompts[0], max_new, stop_at_eos=False)]
        if not all(len(p) > 0 for p in prompts):
            raise ValueError("empty prompt in batch")
        width = min(len(p) for p in prompts)
        tokens = self._tokens([list(p)[-width:] for p in prompts])
        cache = self.model.init_cache(B, self.max_len)
        logits, cache = self.model.prefill(self.params, {"tokens": tokens},
                                           cache)
        tok = torch.argmax(logits[:, -1], dim=-1)
        steps = [tok]
        for _ in range(max_new - 1):
            logits, cache = self.model.decode_step(self.params, tok[:, None],
                                                   cache)
            tok = torch.argmax(logits, dim=-1)
            steps.append(tok)
        outs = torch.stack(steps, dim=1).tolist()
        return [GenResult(seq, len(seq)) for seq in outs]


class QueryRewriter(LMAgent):
    """Emits n sub-queries; token groups release downstream retrieval early
    (the real-pipeline analogue of the workflow expander)."""

    def rewrite(self, query_ids: Sequence[int], n_subqueries: int,
                tokens_each: int = 12) -> List[List[int]]:
        g = self.generate(query_ids, max_new=n_subqueries * tokens_each,
                          stop_at_eos=False)
        toks = g.token_ids
        return [toks[i * tokens_each:(i + 1) * tokens_each]
                for i in range(n_subqueries)]


class SearchPlanner(LMAgent):
    def plan(self, query_ids: Sequence[int], n_requests: int
             ) -> List[List[int]]:
        g = self.generate(query_ids, max_new=n_requests * 8,
                          stop_at_eos=False)
        return [g.token_ids[i * 8:(i + 1) * 8] for i in range(n_requests)]


class ContextRefiner(LMAgent):
    def refine(self, context_ids: Sequence[int], budget: int
               ) -> List[int]:
        g = self.generate(list(context_ids)[:self.max_len - budget - 1],
                          max_new=budget, stop_at_eos=False)
        return g.token_ids
