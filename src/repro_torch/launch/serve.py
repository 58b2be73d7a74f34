"""Serving launcher of the port: HeRo-orchestrated agentic RAG over real
executors, with the stage models in PyTorch and the attention and
retrieval kernels in CUDA.

    PYTHONPATH=src python -m repro_torch.launch.serve --workflow 2 --queries 1
    PYTHONPATH=src python -m repro_torch.launch.serve --full-width \\
        --serve --spec-decode --queries 2

Port of ``repro/launch/serve.py``.  Runs the executable pipeline — chunker,
embedder, vector DB, reranker, rewriter/planner agents, chat generation,
speculative draft — under the HeRo scheduler on the live backend.  The
models run on CUDA unless ``--device cpu`` is given; ``--full-width``
builds the published qwen3 family and qwen1.5-0.5b draft in bf16 instead
of the ``reduced()`` f32 configs.  Every stage fn returns host values, so
wall times include the device work.  All stages share one CUDA stream.
"""
from __future__ import annotations

import argparse
import math
import threading
import time
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

from repro_torch import DeviceLike, resolve_device
from repro_torch.api import HeroSession, SessionOptions
from repro_torch.api.backends import LiveBackend
from repro_torch.api.results import QueryResult
from repro_torch.configs import get_family, reduced as reduce_cfg
from repro_torch.core.dag import DONE
from repro_torch.core.events import EV_RETRY, EV_STRAGGLER
from repro_torch.core.spec_decode import DEFAULT_DRAFT_MODEL, is_draft_stage
from repro_torch.models import build_model
from repro_torch.rag import (HashTokenizer, VectorDB, chunk_documents,
                             default_means, sample_traces,
                             shared_corpus_traces, synth_documents,
                             synth_query)
from repro_torch.rag.agents import LMAgent
from repro_torch.rag.embedder import Embedder, Reranker
from repro_torch.rag.stages import DRAFT_MODELS

# Fixed per-role weight seeds.  The reference seeds each role with
# hash(role) % 97, which Python salts per process; an index into this tuple
# gives the same weights in every run.
ROLES = ("embed", "rerank", "search", "chat", "draft")
# scheduler override under which the live heartbeat never declares a
# running dispatch a straggler
NO_STRAGGLER_REDISPATCH = {"straggler_factor": math.inf}


def build_pipeline(seed: int = 0, *, device: DeviceLike = None,
                   reduced: bool = True):
    """-> (tokenizer, embedder, reranker, rewriter, chat, draft).
    ``reduced=False`` builds the published widths (bf16)."""
    dev = resolve_device(device)
    fam = get_family("qwen3")
    dcfg = DRAFT_MODELS[DEFAULT_DRAFT_MODEL]
    if reduced:
        fam = {k: reduce_cfg(v) for k, v in fam.items()}
        dcfg = reduce_cfg(dcfg)
    cfgs = {**fam, "draft": dcfg}
    models = {role: (cfgs[role], build_model(cfgs[role], dev).init(
                  seed * len(ROLES) + i))
              for i, role in enumerate(ROLES)}
    tok = HashTokenizer(fam["embed"].vocab_size)
    embedder = Embedder(*models["embed"])
    rerank = Reranker(*models["rerank"])
    rewriter = LMAgent(*models["search"], max_len=256)
    chat = LMAgent(*models["chat"], max_len=512)
    draft = LMAgent(*models["draft"], max_len=256)
    return tok, embedder, rerank, rewriter, chat, draft


class StageCounts:
    """Tokens the agents generated and exceptions the stage fns raised,
    summed over the executor threads.  Every attempt's exception counts:
    the runtime retries a raising stage fn (``EV_RETRY``), but drops
    unread the error of an attempt it already cancelled as a straggler."""

    def __init__(self):
        self._lock = threading.Lock()
        self.tokens = 0
        self.errors = 0

    def add_tokens(self, token_lists) -> None:
        with self._lock:
            self.tokens += sum(len(t) for t in token_lists)

    def add_error(self) -> None:
        with self._lock:
            self.errors += 1


def build_stage_fns(seed: int = 0, *, device: DeviceLike = None,
                    reduced: bool = True,
                    counts: Optional[StageCounts] = None):
    """Wire the executable pipeline into perf-stage callables — the
    ``stage_fns`` a live-backend :class:`HeroSession` dispatches to.
    ``counts``, if given, counts every token the agents generate and
    every exception a stage fn raises."""
    tok, embedder, reranker, rewriter, chat, draft = build_pipeline(
        seed, device=device, reduced=reduced)
    counts = counts if counts is not None else StageCounts()

    docs = synth_documents(4, 400, seed=7)
    chunks = chunk_documents(docs, tok)
    db = VectorDB(dim=embedder.cfg.d_model, device=embedder.device)
    query = synth_query(seed=3)
    q_ids = tok.encode(query)

    def fn_embed(node, batch):
        if node.stage == "embed" and "embed_chunks" in node.id:
            take = chunks[: max(batch, 1)]
            db.add(embedder.embed([c.token_ids for c in take]))
            return len(take)
        return embedder.embed([q_ids]).cpu().numpy()

    def fn_vsearch(node, batch):
        return db.search(embedder.embed([q_ids]), k=4)

    def fn_rerank(node, batch):
        scores = reranker.score(q_ids, [chunks[i % len(chunks)].token_ids
                                        for i in range(min(batch, 8))])
        return scores.tolist()

    def fn_llm(node, batch):
        if is_draft_stage(node.stage):
            # speculative draft sub-dispatch: the small draft model streams
            # spec_width candidate tokens per verify pass
            out = draft.generate(q_ids[:16],
                                 max_new=min(node.workload, 16)).token_ids
            counts.add_tokens([out])
            return out
        agent = rewriter if node.stage.startswith(("rewrite", "plan")) \
            else chat
        if node.kind == "stream_prefill":
            return "prefill"
        members = node.payload.get("members")
        if members:
            # resident continuous-batching decode round: ONE width-B call
            # serves every member's token group; results slice back per
            # query (member id -> tokens)
            group = max(1, min(batch, 8))
            outs = agent.generate_batch([q_ids[:16]] * len(members),
                                        max_new=group)
            counts.add_tokens(g.token_ids for g in outs)
            if node.payload.get("spec_width"):
                # speculative verify pass: accept the drafted prefix that
                # matches the target's own greedy tokens (both models are
                # deterministic, so regenerating the draft's candidates here
                # is exact) and stamp the per-member accept counts
                douts = draft.generate_batch([q_ids[:16]] * len(members),
                                             max_new=group)
                counts.add_tokens(g.token_ids for g in douts)
                node.payload["spec_accepts"] = {
                    m.id: sum(1 for a, b in zip(g.token_ids, dg.token_ids)
                              if a == b)
                    for m, g, dg in zip(members, outs, douts)}
            return {m.id: g.token_ids for m, g in zip(members, outs)}
        out = agent.generate(q_ids[:16], max_new=min(batch, 8)).token_ids
        counts.add_tokens([out])
        return out

    def counted(fn):
        def run(node, batch):
            try:
                return fn(node, batch)
            except Exception:
                counts.add_error()
                raise
        return run

    stage_fns = {s: fn_llm for s in
                 ("rewrite_prefill", "rewrite_decode", "plan_prefill",
                  "plan_decode", "refine_prefill", "refine_decode",
                  "chat_prefill", "chat_decode", "rewrite_draft",
                  "plan_draft", "refine_draft", "chat_draft")}
    stage_fns.update(embed=fn_embed, vsearch=fn_vsearch, rerank=fn_rerank,
                     __io__=lambda n, b: time.sleep(0.05))
    return {s: counted(fn) for s, fn in stage_fns.items()}


class RecordingLiveBackend(LiveBackend):
    """The live backend, keeping every DAG it ran and its events, so a
    caller can check that each node finished and no stage fn was retried
    (the runtime retries a raising stage fn, which would hide a fault that
    passes on the second try)."""

    def __init__(self, stage_fns):
        super().__init__(stage_fns=stage_fns)
        self.dags, self.events = [], []

    def execute(self, dag, scheduler, observer=None, timeout=300.0):
        self.dags.append(dag)
        run = super().execute(dag, scheduler, observer=observer,
                              timeout=timeout)
        self.events.extend(run.events)
        return run


@dataclass
class ServeReport:
    session: HeroSession
    results: List[QueryResult]
    wall_s: float          # host clock around the whole run
    tokens: int            # tokens the agents generated
    nodes: int             # DAG nodes over every run
    unfinished: List[str]  # ids of nodes that did not reach DONE
    retries: int           # EV_RETRY events: a stage fn raised
    stage_errors: int      # exceptions over every attempt, cancelled too
    stragglers: int        # EV_STRAGGLER events: a dispatch overran its ETA


def main(argv: Optional[Sequence[str]] = None) -> ServeReport:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workflow", type=int, default=2, choices=[1, 2, 3])
    ap.add_argument("--queries", type=int, default=2)
    ap.add_argument("--dataset", default="finqabench")
    ap.add_argument("--serve", action="store_true",
                    help="continuous serving mode: staggered admission into "
                         "one shared DAG with cross-query coalescing and "
                         "continuous decode batching (default: the paper's "
                         "isolated single-query latency protocol)")
    ap.add_argument("--inter-arrival", type=float, default=0.5,
                    help="seconds between arrivals in --serve mode")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="turn on the paged-KV subsystem and point every "
                         "query at one shared retrieved corpus "
                         "(implies --serve admission)")
    ap.add_argument("--spec-decode", action="store_true",
                    help="speculative decoding: decode rounds dispatch as "
                         "coupled (draft, verify) pairs (implies --serve "
                         "admission)")
    ap.add_argument("--device", default=None,
                    help="torch device for the stage models (default: "
                         "cuda; 'cpu' runs the plain PyTorch path)")
    ap.add_argument("--full-width", action="store_true",
                    help="published qwen3 / qwen1.5-0.5b widths in bf16 "
                         "instead of the reduced f32 test configs")
    ap.add_argument("--no-straggler-redispatch", action="store_true",
                    help="never dispatch a running stage again as a "
                         "straggler; the heartbeat's ETAs come from the "
                         "perf model of the mobile SoC, not this device, "
                         "so the re-dispatched copies duplicate work")
    args = ap.parse_args(argv)

    if args.prefix_cache or args.spec_decode:
        args.serve = True
    if args.prefix_cache:
        traces = shared_corpus_traces(args.dataset, args.queries, seed=1)
    else:
        traces = sample_traces(args.dataset, args.queries, seed=1)
    counts = StageCounts()
    backend = RecordingLiveBackend(build_stage_fns(
        device=args.device, reduced=not args.full_width, counts=counts))
    sess = HeroSession(world="sd8gen4", family="qwen3", backend=backend,
                       means=default_means(traces),
                       options=SessionOptions(
                           coalesce=bool(args.serve),
                           kv_pages=bool(args.prefix_cache),
                           spec_decode=bool(args.spec_decode),
                           cfg_overrides=NO_STRAGGLER_REDISPATCH
                           if args.no_straggler_redispatch else None))
    for qi, tr in enumerate(traces):
        sess.submit(tr, wf=args.workflow,
                    arrival_time=qi * args.inter_arrival if args.serve
                    else 0.0)
    t0 = time.monotonic()
    results = sess.run(mode="shared" if args.serve else "isolated",
                       timeout=600)
    wall = time.monotonic() - t0
    for res in results:
        extra = (f", {res.decode_rounds} batched decode rounds"
                 if res.decode_rounds else "")
        if res.kv_page_hits:
            extra += (f", {res.kv_page_hits} KV page hits "
                      f"({res.kv_hit_tokens} prefill tokens skipped)")
        print(f"query {res.qid}: {res.n_nodes} sub-stages in "
              f"{res.makespan:.2f}s wall{extra}")
    print(f"mean wall latency: {np.mean([r.makespan for r in results]):.2f}s "
          f"over {len(results)} queries")
    report = ServeReport(
        session=sess, results=results, wall_s=wall, tokens=counts.tokens,
        nodes=sum(len(d.nodes) for d in backend.dags),
        unfinished=[n.id for d in backend.dags for n in d.nodes.values()
                    if n.status != DONE],
        retries=sum(1 for e in backend.events if e[1] == EV_RETRY),
        stage_errors=counts.errors,
        stragglers=sum(1 for e in backend.events if e[1] == EV_STRAGGLER))
    print(f"run: {wall:.2f}s wall, {report.tokens} tokens generated, "
          f"{report.nodes} nodes ({len(report.unfinished)} unfinished), "
          f"{report.retries} retries, {report.stage_errors} stage errors, "
          f"{report.stragglers} stragglers")
    run = sess.last_run
    if args.prefix_cache and run is not None:
        print(f"prefix cache: {run.kv_page_hits} page hits, "
              f"{run.kv_hit_tokens} tokens skipped, "
              f"{run.kv_evictions} evictions")
    if args.spec_decode and run is not None:
        rate = (run.accepted_tokens / run.drafted_tokens
                if run.drafted_tokens else 0.0)
        print(f"spec decode: {run.spec_rounds} speculative rounds, "
              f"{run.drafted_tokens} drafted / {run.accepted_tokens} "
              f"accepted tokens (rate {rate:.2f})")
    return report


if __name__ == "__main__":
    main()
