"""Synthetic dataset trace generators matching the paper's four benchmarks
(§6.1): FinqaBench and TruthfulQA (short queries ≤70 tokens, ~200-token
contexts) vs HotpotQA and 2WikiMultihopQA (longer, multi-hop contexts up to
1k tokens, more agent branching).  Extreme-length outliers are excluded, as
in the paper.

A trace drives one workflow execution: workload sizes per stage + the agent
decisions (how many sub-queries the rewriter emits, whether the planner
fires web searches) — the *dynamic dependencies* of §3.1.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List

import numpy as np


@dataclass(frozen=True)
class QueryTrace:
    dataset: str
    query_tokens: int
    context_tokens: int          # retrieved context budget for the chat stage
    n_docs: int                  # documents to index (workflow 1 ingest)
    n_chunks: int                # chunks produced by the chunker
    rerank_candidates: int
    # agent decisions (dynamic):
    n_subqueries: int            # rewriter output (W2/W3)
    rewrite_tokens: int          # rewriter decode length
    n_web_searches: int          # planner output (W3)
    plan_tokens: int             # planner decode length
    refine_tokens: int           # refiner decode length
    answer_tokens: int           # chat decode length
    # identities of the retrieved chunks, in rank order — the content keys
    # the paged-KV prefix cache hashes per page boundary.  Empty (the
    # default, and what sample_traces emits) = no prefix identity: every
    # prefill is unique, exactly the pre-paging behavior
    chunk_ids: tuple = ()


@dataclass(frozen=True)
class DatasetSpec:
    name: str
    query_tok: tuple             # (lo, hi)
    ctx_tok: tuple
    doc_tok: tuple               # per-document length
    n_docs: tuple
    subq: tuple                  # rewriter branching
    web: tuple                   # planner branching
    answer_tok: tuple


DATASETS: Dict[str, DatasetSpec] = {
    "finqabench": DatasetSpec("finqabench", (16, 70), (120, 240),
                              (300, 900), (2, 5), (1, 3), (1, 2), (24, 72)),
    "truthfulqa": DatasetSpec("truthfulqa", (10, 48), (100, 220),
                              (200, 600), (1, 4), (1, 3), (1, 2), (16, 56)),
    "hotpotqa": DatasetSpec("hotpotqa", (18, 90), (400, 1000),
                            (500, 1600), (4, 10), (2, 4), (1, 3), (32, 96)),
    "2wikimqa": DatasetSpec("2wikimqa", (16, 80), (400, 1000),
                            (500, 1800), (4, 10), (2, 5), (2, 4), (32, 96)),
}


def sample_traces(dataset: str, n: int, seed: int = 0,
                  chunk_size: int = 128, overlap: int = 10
                  ) -> List[QueryTrace]:
    spec = DATASETS[dataset]
    rng = np.random.default_rng(seed)

    def u(lohi):
        return int(rng.integers(lohi[0], lohi[1] + 1))

    out = []
    for _ in range(n):
        n_docs = u(spec.n_docs)
        doc_tokens = [u(spec.doc_tok) for _ in range(n_docs)]
        step = chunk_size - overlap
        n_chunks = sum(max(1, -(-max(t - overlap, 1) // step))
                       for t in doc_tokens)
        out.append(QueryTrace(
            dataset=dataset,
            query_tokens=u(spec.query_tok),
            context_tokens=u(spec.ctx_tok),
            n_docs=n_docs,
            n_chunks=n_chunks,
            rerank_candidates=min(max(8, n_chunks // 2), 32),
            n_subqueries=u(spec.subq),
            rewrite_tokens=u((16, 48)),
            n_web_searches=u(spec.web),
            plan_tokens=u((16, 40)),
            refine_tokens=u((24, 64)),
            answer_tokens=u(spec.answer_tok),
        ))
    return out


# --- real-text corpus for the executable pipeline --------------------------

_WORDS = ("market growth revenue quarter fiscal policy model system data "
          "retrieval neural mobile device latency memory bandwidth processor "
          "energy thermal schedule graph agent query document answer context "
          "index vector embedding rank search web page result fact entity "
          "relation hop reasoning finance question report analysis").split()


def synth_documents(n_docs: int, tokens_per_doc: int, seed: int = 0
                    ) -> List[str]:
    rng = np.random.default_rng(seed)
    docs = []
    for _ in range(n_docs):
        words = rng.choice(_WORDS, size=tokens_per_doc)
        docs.append(" ".join(words.tolist()))
    return docs


def synth_query(seed: int = 0, tokens: int = 24) -> str:
    rng = np.random.default_rng(seed + 10_007)
    return " ".join(rng.choice(_WORDS, size=tokens).tolist())
