"""Serving engine — port of ``repro/serving/engine.py``: chunked prefill +
continuous batching for one stage model.

Requests are admitted into at most ``MAX_SLOTS`` slots, each with its own
batch-1 cache; prefill runs in chunks of ``prefill_chunk`` tokens (the
paper's chunked-prefill mechanism — each chunk is a schedulable sub-stage
for HeRo), one chunk per engine step, and decode runs in token groups.
The engine runs on the device its parameters live on, as ``LMAgent``
does, and serves every family ``build_model`` serves.  Caches are updated
in place; no step is compiled (PyTorch runs eagerly).
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Dict, List, Sequence

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import Model, build_model
from repro_torch.models.lm import LM
from repro_torch.rag.tokenizer import EOS

MAX_SLOTS = 4


@dataclass
class Request:
    rid: int
    prompt_ids: List[int]
    max_new: int
    # runtime
    generated: List[int] = field(default_factory=list)
    prefilled: int = 0
    done: bool = False


class ServingEngine:
    def __init__(self, cfg: ModelConfig, params: LM, *, max_len: int = 1024,
                 prefill_chunk: int = 128, token_group: int = 8):
        self.cfg = cfg
        self.params = params
        self.device = params.embed.device
        self.model: Model = build_model(cfg, self.device)
        self.max_len = max_len
        self.prefill_chunk = prefill_chunk
        self.token_group = token_group
        self._rid = itertools.count()
        self.queue: List[Request] = []
        self.active: Dict[int, dict] = {}    # rid -> {cache, req}

    # -- API -----------------------------------------------------------------
    def submit(self, prompt_ids: Sequence[int], max_new: int = 32) -> int:
        rid = next(self._rid)
        self.queue.append(Request(rid, list(prompt_ids), max_new))
        return rid

    def step(self) -> List[Request]:
        """One engine step: admit + prefill one chunk each, then one decode
        token group for running requests.  Returns finished requests."""
        self._admit()
        self._prefill_step()
        return self._decode_step()

    def run_to_completion(self, max_steps: int = 10_000) -> List[Request]:
        out = []
        for _ in range(max_steps):
            out.extend(self.step())
            if not self.queue and not self.active:
                break
        return out

    # -- internals -------------------------------------------------------------
    def _tokens(self, ids: Sequence[int]) -> torch.Tensor:
        return torch.tensor([list(ids)], dtype=torch.int64,
                            device=self.device)

    def _admit(self):
        while self.queue and len(self.active) < MAX_SLOTS:
            req = self.queue.pop(0)
            cache = self.model.init_cache(1, self.max_len)
            self.active[req.rid] = {"req": req, "cache": cache}

    @torch.no_grad()
    def _prefill_step(self):
        for slot in self.active.values():
            req = slot["req"]
            if req.prefilled >= len(req.prompt_ids):
                continue
            # chunked prefill: one chunk per engine step (a HeRo sub-stage)
            end = min(req.prefilled + self.prefill_chunk,
                      len(req.prompt_ids))
            chunk = self._tokens(req.prompt_ids[req.prefilled:end])
            logits, slot["cache"] = self.model.prefill(
                self.params, {"tokens": chunk}, slot["cache"])
            req.prefilled = end
            if end == len(req.prompt_ids):
                req.generated.append(int(torch.argmax(logits[0, -1])))

    @torch.no_grad()
    def _decode_step(self) -> List[Request]:
        finished = []
        for rid in list(self.active):
            slot = self.active[rid]
            req = slot["req"]
            if req.prefilled < len(req.prompt_ids) or not req.generated:
                continue
            for _ in range(self.token_group):
                if len(req.generated) >= req.max_new or \
                        req.generated[-1] == EOS:
                    req.done = True
                    break
                logits, slot["cache"] = self.model.decode_step(
                    self.params, self._tokens([req.generated[-1]]),
                    slot["cache"])
                req.generated.append(int(torch.argmax(logits[0])))
            if len(req.generated) >= req.max_new:
                req.done = True
            if req.done:
                finished.append(req)
                del self.active[rid]
        return finished
