"""The paper's three agentic RAG workflows (§6.1) as dynamic task graphs.

W1  Fast Document Finder   : chunk→embed→index→retrieve→rerank→generate
W2  Advanced Document QA   : + LLM query rewriting (N sub-queries, each
                             spawning retrieve+rerank branches at runtime)
                             + per-branch context refinement (RECOMP-style
                             compression of each retrieved set, paper [27])
W3  Deep Researcher        : + search planner issuing web requests

The canonical workflow definitions now live in ``repro_torch.api.spec`` as
declarative :class:`~repro_torch.api.spec.WorkflowSpec` objects, from which both
the runtime :class:`DynamicDAG` (with its §3.1 dynamic branch expanders
and per-token-group early release) and the Eq. 4
:class:`WorkflowTemplate` prior are derived — one description, two
artifacts.  Define new workflows there (or pass a custom spec to
``HeroSession.submit``); the functions below are thin compatibility
wrappers over ``builtin_spec(1..3)`` kept for the figure benchmarks.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.core.dag import DynamicDAG, WorkflowTemplate
from repro_torch.rag.datasets import QueryTrace


def build_w1(trace: QueryTrace, fine_grained: bool = True,
             prefix: str = "", dag: DynamicDAG = None) -> DynamicDAG:
    from repro_torch.api.spec import builtin_spec
    return builtin_spec(1).build_dag(trace, fine_grained=fine_grained,
                                     prefix=prefix, dag=dag)


def build_w2(trace: QueryTrace, fine_grained: bool = True,
             prefix: str = "", dag: DynamicDAG = None) -> DynamicDAG:
    from repro_torch.api.spec import builtin_spec
    return builtin_spec(2).build_dag(trace, fine_grained=fine_grained,
                                     prefix=prefix, dag=dag)


def build_w3(trace: QueryTrace, fine_grained: bool = True,
             prefix: str = "", dag: DynamicDAG = None) -> DynamicDAG:
    from repro_torch.api.spec import builtin_spec
    return builtin_spec(3).build_dag(trace, fine_grained=fine_grained,
                                     prefix=prefix, dag=dag)


BUILDERS = {1: build_w1, 2: build_w2, 3: build_w3}


def build_workflow(wf: int, trace: QueryTrace,
                   fine_grained: bool = True) -> DynamicDAG:
    return BUILDERS[wf](trace, fine_grained)


def shared_corpus_traces(dataset: str, k: int, seed: int = 0,
                         n_docs: int = 4, context_tokens: int = 768,
                         chunks_per_doc: int = 4):
    """``k`` traces over ONE shared ``n_docs``-document corpus: every
    query retrieves the same ranked chunk list (identical ``chunk_ids``)
    under the same context budget — the dominant serving pattern the
    cross-query prefix cache exists for (many users asking about the same
    few documents).  Query/answer lengths still vary per trace, so only
    the retrieved-context prefix is shareable, exactly as in a real
    deployment."""
    import dataclasses

    from repro_torch.rag.datasets import sample_traces
    traces = sample_traces(dataset, k, seed=seed)
    chunk_ids = tuple(f"d{seed}.{i // chunks_per_doc}.c{i % chunks_per_doc}"
                      for i in range(n_docs * chunks_per_doc))
    return [dataclasses.replace(t, n_docs=n_docs, chunk_ids=chunk_ids,
                                context_tokens=context_tokens)
            for t in traces]


# -- workflow template (future-criticality prior, Eq. 4) ---------------------

def make_template(wf: int, mean: Dict[str, float]) -> WorkflowTemplate:
    """mean: historical means over traces (see default_means).  Derived
    from the same ``WorkflowSpec`` as the runtime DAG."""
    from repro_torch.api.spec import builtin_spec
    return builtin_spec(wf).build_template(mean)


def default_means(dataset_traces) -> Dict[str, float]:
    import numpy as np
    tr = dataset_traces
    return {
        "n_chunks": float(np.mean([t.n_chunks for t in tr])),
        "rerank": float(np.mean([t.rerank_candidates for t in tr])),
        "query_tokens": float(np.mean([t.query_tokens for t in tr])),
        "rewrite_tokens": float(np.mean([t.rewrite_tokens for t in tr])),
        "n_subqueries": float(np.mean([t.n_subqueries for t in tr])),
        "context_tokens": float(np.mean([t.context_tokens for t in tr])),
        "refine_tokens": float(np.mean([t.refine_tokens for t in tr])),
        "plan_tokens": float(np.mean([t.plan_tokens for t in tr])),
        "n_web": float(np.mean([t.n_web_searches for t in tr])),
        "answer_tokens": float(np.mean([t.answer_tokens for t in tr])),
    }
