"""Declarative workflow specifications — the canonical workflow definition.

A :class:`WorkflowSpec` describes an agentic RAG workflow once and derives
BOTH runtime artifacts from that single description:

- ``build_dag(trace)``   -> the :class:`DynamicDAG` the scheduler executes
  (including the dynamic branch expanders of paper §3.1), and
- ``build_template(means)`` -> the Eq. 4 :class:`WorkflowTemplate` used as
  the future-criticality prior.

This collapses the duplication that used to live in
``rag/workflow.py`` between ``build_w1/w2/w3`` and ``make_template`` and
makes user-defined workflows first-class: compose :class:`StageSpec`,
:class:`BranchGroup` and :class:`CollectorSpec` and hand the spec to
``HeroSession.submit(trace, spec=...)``.

Vocabulary
----------
- *statics*: stages known before execution (G_obs(0)).
- *branch groups*: sub-graphs spawned at runtime by a decision stage
  (query rewriter, search planner) — the dynamic inter-stage dependencies
  of §3.1.  ``progressive`` groups release branches per finished
  token-group of the source decode, so the first sub-query's retrieval
  starts before the rewriter finishes (the paper's motivating example).
- *collector*: the paper's RECOMP-style per-branch refine + chunked chat
  prefill pattern; fine-grained mode chains one chat-prefill piece per
  refined branch (§4.2), coarse mode gates a monolithic prefill on all
  branch tails.

Workload callables receive a :class:`View` — one canonical namespace over
either a concrete ``QueryTrace`` (ints, for the DAG) or a means dict
(floats, for the template prior) — so each workload formula is written
exactly once.
"""
from __future__ import annotations

import dataclasses
import warnings
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

from repro_torch.core.dag import DynamicDAG, Node, WorkflowTemplate

Workload = Callable[["View"], float]

_ONE: Workload = lambda v: 1  # noqa: E731

# QueryTrace field -> canonical View name (means dicts already use these)
_TRACE_ALIASES = {"rerank_candidates": "rerank", "n_web_searches": "n_web"}


class View:
    """Attribute bag over a trace or a means dict (canonical names)."""

    def __init__(self, values: Dict[str, Any]):
        self.__dict__.update(values)

    @classmethod
    def of(cls, source) -> "View":
        if isinstance(source, View):
            return source
        if isinstance(source, Mapping):
            return cls(dict(source))
        vals = {}
        for k in dir(source):
            if k.startswith("_"):
                continue
            val = getattr(source, k)
            if isinstance(val, (int, float, str)):
                vals[_TRACE_ALIASES.get(k, k)] = val
            elif isinstance(val, tuple):
                # structured trace fields (e.g. retrieved chunk_ids — the
                # prefix-cache content keys) pass through verbatim
                vals[_TRACE_ALIASES.get(k, k)] = val
        return cls(vals)


@dataclass(frozen=True)
class DecodeSpec:
    """Typed decode-side configuration of one :class:`StageSpec`.

    Collapses the stringly decode knobs into one validated object:

    - ``kv_stage``: the decode stage whose profiled KV shape denominates
      this stage's cache pages — what the deprecated ``StageSpec.kv_stage``
      kwarg used to stamp as raw ``payload["kv_decode_stage"]``.  Custom
      specs whose stage names do not follow the ``*_prefill``/``*_decode``
      convention MUST set it (see :func:`repro_torch.core.kv_pages.decode_stage_for`).
    - ``draft_model``: the in-tree draft family allowed to speculate for
      this decode stage (validated against ``rag.stages.DRAFT_MODELS``).
      When the session-level draft differs, speculation is disabled for
      this stage rather than run under the wrong draft.
    - ``draft_width``: per-stage draft-width pin.  The scheduler snaps it
      to the profiled width grid and skips the batch policy's candidate
      search for this stage.

    ``build_dag`` stamps the validated object as ``payload["decode_spec"]``;
    the paged-KV tracker and the scheduler consume it typed-first, keeping
    the legacy ``kv_decode_stage`` payload key as a fallback for
    hand-built nodes.
    """

    kv_stage: Optional[str] = None
    draft_model: Optional[str] = None
    draft_width: Optional[int] = None

    def __post_init__(self):
        if self.draft_width is not None and self.draft_width < 1:
            raise ValueError(
                f"DecodeSpec.draft_width must be >= 1, got "
                f"{self.draft_width!r}")
        if self.draft_model is not None:
            from repro_torch.rag.stages import DRAFT_MODELS
            if self.draft_model not in DRAFT_MODELS:
                raise ValueError(
                    f"DecodeSpec.draft_model {self.draft_model!r} is not "
                    f"an in-tree draft family; pick from "
                    f"{sorted(DRAFT_MODELS)}")


@dataclass(frozen=True)
class StageSpec:
    """One statically-known stage."""

    id: str
    stage: str                                # perf-model key
    kind: str                                 # batchable | stream_* | search | io
    workload: Workload
    deps: Tuple[str, ...] = ()
    template: Optional[str] = None            # template stage id (default: id)
    mean_workload: Optional[Workload] = None  # template-side override
    template_deps: Optional[Tuple[str, ...]] = None
    role: Optional[str] = None                # baseline static-map role
    # opt this stage out of cross-query batch coalescing (e.g. stages with
    # per-query side effects that must not share a dispatch)
    coalescable: bool = True
    # stream_prefill only: tokens at the HEAD of this prefill that encode
    # raw retrieved context (prompt order: [shared context][query...]) —
    # prefix-cacheable across queries retrieving the same chunk ids.
    # Stamped as payload["prefix_segments"] when the trace carries
    # chunk_ids; the paged-KV prefix cache keys page hashes off it
    shared_ctx: Optional[Workload] = None
    # typed decode-side configuration: KV-shape override + speculative
    # draft placement (model / width pins).  See :class:`DecodeSpec`
    decode: Optional[DecodeSpec] = None
    # DEPRECATED: pass ``decode=DecodeSpec(kv_stage=...)`` instead.  Kept
    # as a shim that folds into ``decode`` with a DeprecationWarning
    kv_stage: Optional[str] = None

    def __post_init__(self):
        if self.kv_stage is None:
            return
        warnings.warn(
            "StageSpec.kv_stage is deprecated; pass "
            "decode=DecodeSpec(kv_stage=...) instead",
            DeprecationWarning, stacklevel=3)
        dec = self.decode
        if dec is None:
            dec = DecodeSpec(kv_stage=self.kv_stage)
        elif dec.kv_stage is None:
            dec = dataclasses.replace(dec, kv_stage=self.kv_stage)
        elif dec.kv_stage != self.kv_stage:
            raise ValueError(
                f"StageSpec {self.id!r}: deprecated kv_stage="
                f"{self.kv_stage!r} conflicts with decode.kv_stage="
                f"{dec.kv_stage!r}")
        object.__setattr__(self, "decode", dec)

    @property
    def tid(self) -> str:
        return self.template or self.id


@dataclass(frozen=True)
class BranchStage:
    """One stage of a dynamically-spawned branch.  ``id`` is a format
    string over the branch index ``{i}``; deps may reference ``$source``
    (the decision node that spawned the branch), ``$prev`` (the previous
    stage in this branch) or any static stage id."""

    id: str
    stage: str
    kind: str
    workload: Workload
    deps: Tuple[str, ...]
    template: str
    mean_workload: Optional[Workload] = None
    template_deps: Optional[Tuple[str, ...]] = None
    role: Optional[str] = None
    coalescable: bool = True                  # see StageSpec.coalescable


@dataclass(frozen=True)
class BranchGroup:
    """Branches spawned by ``source`` at runtime (dynamic deps, §3.1)."""

    source: str                               # static id of the decision stage
    count: Workload                           # branches per query
    stages: Tuple[BranchStage, ...]
    label: str = "b{i}"                       # per-branch key (collector ids)
    progressive: bool = False                 # spawn per source token-group
    to_collector: bool = True                 # tail feeds the refine/chat sink


@dataclass(frozen=True)
class CollectorSpec:
    """RECOMP-style refine of every branch + (chunked) chat generation."""

    base_dep: str                             # static id of the base branch tail
    refine_prefill: str = "refine_prefill"
    refine_decode: str = "refine_decode"
    chat_prefill: str = "chat_prefill"
    chat_decode: str = "chat_decode"
    context: Workload = lambda v: v.context_tokens
    refine_out: Workload = lambda v: v.refine_tokens
    query: Workload = lambda v: v.query_tokens
    answer: Workload = lambda v: v.answer_tokens
    ctx_floor: int = 32
    refine_floor: int = 8
    role: str = "chat"


@dataclass(frozen=True)
class WorkflowSpec:
    name: str
    statics: Tuple[StageSpec, ...]
    groups: Tuple[BranchGroup, ...] = ()
    collector: Optional[CollectorSpec] = None

    # -- helpers -------------------------------------------------------------
    def _static(self, sid: str) -> StageSpec:
        for s in self.statics:
            if s.id == sid:
                return s
        raise KeyError(f"{self.name}: unknown static stage {sid!r}")

    def final_decode(self) -> Optional[str]:
        """Template id of the answer-generation decode stage (the target of
        per-token streaming callbacks)."""
        if self.collector is not None:
            return self.collector.chat_decode
        for s in reversed(self.statics):
            if s.kind == "stream_decode":
                return s.tid
        return None

    def stage_roles(self) -> Dict[str, str]:
        """Perf-stage -> role map for baseline static mappings
        (``strategy_config``)."""
        default = {"search": "search", "io": "io"}
        roles: Dict[str, str] = {}
        for s in self.statics:
            if s.role is not None:
                roles[s.stage] = s.role
            else:
                roles.setdefault(s.stage, default.get(s.kind, "chat"))
        for g in self.groups:
            for bs in g.stages:
                if bs.role is not None:
                    roles[bs.stage] = bs.role
                else:
                    # a branch stage reusing a static's perf stage (embed_sq
                    # -> "embed") inherits that static's role
                    roles.setdefault(bs.stage, default.get(bs.kind, "chat"))
        if self.collector is not None:
            c = self.collector
            for stage in (c.refine_prefill, c.refine_decode,
                          c.chat_prefill, c.chat_decode):
                roles.setdefault(stage, c.role)
        return roles

    # -- DAG derivation ------------------------------------------------------
    def build_dag(self, trace, fine_grained: bool = True, prefix: str = "",
                  dag: Optional[DynamicDAG] = None,
                  gate_dep: Optional[str] = None,
                  validate: bool = False) -> DynamicDAG:
        """Materialize G_obs(0) (+ runtime expanders) for one query.

        ``gate_dep``: optional node id every root stage depends on — the
        session's admission gate (a timer node carrying the query's
        arrival time).

        ``validate``: run ``repro_torch.analysis.validate`` over this spec
        first — structural errors (dep cycles, unknown deps, DecodeSpec
        placement, the kv_stage naming trap) raise
        :class:`repro_torch.analysis.validate.SpecValidationError` before any
        node is materialized.  Off by default (the session enables it
        via ``SessionOptions.validate_spec``); imported lazily so the
        core build path never depends on the analysis package."""
        if validate:
            from repro_torch.analysis.validate import ensure_valid
            ensure_valid(spec=self)
        dag = dag if dag is not None else DynamicDAG()
        v = View.of(trace)
        col = self.collector

        def N(s: str) -> str:
            return prefix + s

        def W(fn: Workload) -> int:
            return max(int(fn(v)), 1)

        def add(d, nid, stage, kind, workload, deps, template,
                coalescable=True, shared_ctx=0, decode=None):
            n = d.add(Node(id=nid, stage=stage, kind=kind,
                           workload=max(int(workload), 1),
                           deps=set(deps), template=template))
            if not coalescable:
                n.payload["no_coalesce"] = True
            if decode is not None:
                # typed decode-side config (DecodeSpec): the paged tracker
                # reads its kv_stage instead of guessing by the
                # *_prefill/*_decode naming convention; the scheduler reads
                # its draft_model / draft_width pins for spec decoding
                n.payload["decode_spec"] = decode
            if kind == "stream_decode":
                # base KV context the stream inherits from its prefill
                # deps — what KV-residency tracking charges before any
                # decoded tokens (fine-grained chat decodes override this
                # below with the full chunked context)
                n.payload["kv_ctx"] = sum(
                    d.nodes[dep].workload for dep in n.deps
                    if d.nodes[dep].kind == "stream_prefill")
                for dep in n.deps:
                    if d.nodes[dep].kind == "stream_prefill":
                        # link prefill pieces to the decode stream whose
                        # cache they fill (paged-KV page adoption)
                        d.nodes[dep].payload["kv_stream"] = n.id
            elif kind == "stream_prefill" and shared_ctx > 0:
                kvs = decode.kv_stage if decode is not None else None
                if kvs is None and not stage.endswith("_prefill"):
                    # the convention trap, caught at build time: without
                    # an override the tracker would page this prefill's
                    # cache under a guessed (wrong) decode shape — warn
                    # and fall back to no prefix caching instead
                    warnings.warn(
                        f"{self.name}: stage {stage!r} (node {nid!r}) "
                        "declares shared_ctx but does not follow the "
                        "*_prefill naming convention and sets no "
                        "StageSpec.kv_stage override — prefix caching "
                        "disabled for it to avoid paging its KV under "
                        "the wrong profiled shape",
                        RuntimeWarning, stacklevel=2)
                    return n
                chunks = getattr(v, "chunk_ids", ())
                if chunks:
                    # prefix-cache content identity, in prompt order: the
                    # shared retrieved-context head (keyed by the BARE
                    # stage id + chunk ids, so every admitted query
                    # retrieving the same chunks maps to the same pages)
                    # then the per-query remainder (keyed by the full node
                    # id — never shared)
                    head = min(int(shared_ctx), n.workload)
                    bare = (nid[len(prefix):]
                            if prefix and nid.startswith(prefix) else nid)
                    segs = [(f"ctx:{bare}:{','.join(map(str, chunks))}",
                             head)]
                    if n.workload > head:
                        segs.append((f"q:{nid}", n.workload - head))
                    n.payload["prefix_segments"] = tuple(segs)
            return n

        gate = [gate_dep] if gate_dep is not None else []

        # collector sizing: per-source context/refine pieces
        refine_tails: List[str] = []
        chat_state = {"last": None, "pieces": 0}
        if col is not None:
            n_sources = 1 + sum(int(g.count(v)) for g in self.groups
                                if g.to_collector)
            ctx_piece = max(int(col.context(v)) // n_sources, col.ctx_floor)
            refine_piece = max(int(col.refine_out(v)) // n_sources,
                               col.refine_floor)
            q_tokens = int(col.query(v))

        def add_chat_piece(d: DynamicDAG, dep: str):
            if col is None or not fine_grained:
                return
            prev = chat_state["last"]
            nid = N(f"{col.chat_prefill}_{chat_state['pieces']}")
            add(d, nid, col.chat_prefill, "stream_prefill", ctx_piece,
                deps=[dep, prev], template=col.chat_prefill)
            chat_state["last"] = nid
            chat_state["pieces"] += 1
            if N(col.chat_decode) in d.nodes:
                d.retarget_dep(N(col.chat_decode), prev, nid)

        def add_branch_refine(d: DynamicDAG, key: str, dep: str):
            # a refine prefill reads a raw retrieved-context piece: fully
            # prefix-shareable across queries on the same chunk ids
            rp = add(d, N(f"{col.refine_prefill}_{key}"), col.refine_prefill,
                     "stream_prefill", ctx_piece, deps=[dep],
                     template=col.refine_prefill, shared_ctx=ctx_piece)
            rd = add(d, N(f"{col.refine_decode}_{key}"), col.refine_decode,
                     "stream_decode", refine_piece, deps=[rp.id],
                     template=col.refine_decode)
            refine_tails.append(rd.id)
            if fine_grained:
                add_chat_piece(d, rd.id)
            elif N(col.chat_prefill) in d.nodes:
                d.add_edge(rd.id, N(col.chat_prefill))
            return rd

        # statics (the collector's base refine chain is inserted right after
        # its base_dep stage, preserving the legacy builders' graph order)
        for s in self.statics:
            deps = [N(d) for d in s.deps] if s.deps else list(gate)
            add(dag, N(s.id), s.stage, s.kind, W(s.workload), deps=deps,
                template=s.tid, coalescable=s.coalescable,
                shared_ctx=(int(s.shared_ctx(v))
                            if s.shared_ctx is not None else 0),
                decode=s.decode)
            if col is not None and s.id == col.base_dep:
                # base-branch refine; its chat piece is the chain head (it
                # carries the query tokens), not an add_chat_piece link
                rp = add(dag, N(f"{col.refine_prefill}_base"),
                         col.refine_prefill, "stream_prefill", ctx_piece,
                         deps=[N(s.id)], template=col.refine_prefill,
                         shared_ctx=ctx_piece)
                rd = add(dag, N(f"{col.refine_decode}_base"),
                         col.refine_decode, "stream_decode", refine_piece,
                         deps=[rp.id], template=col.refine_decode)
                refine_tails.append(rd.id)
                if fine_grained:
                    nid = N(f"{col.chat_prefill}_0")
                    add(dag, nid, col.chat_prefill, "stream_prefill",
                        ctx_piece + q_tokens, deps=[rd.id],
                        template=col.chat_prefill)
                    chat_state["last"], chat_state["pieces"] = nid, 1

        # dynamic branch groups: wire expanders onto the decision stages
        for g in self.groups:
            self._wire_group(dag, g, v, N, add, add_branch_refine,
                             fine_grained)

        # chat tail gated on every decision stage, so dynamically-spawned
        # branches are always observed before generation starts
        if col is not None:
            gate_ids = [N(g.source) for g in self.groups]
            if fine_grained:
                cd = add(dag, N(col.chat_decode), col.chat_decode,
                         "stream_decode", int(col.answer(v)),
                         deps=[chat_state["last"]] + gate_ids,
                         template=col.chat_decode)
                cd.payload["chat_state"] = chat_state
                # fine-grained mode chains one prefill piece per branch:
                # the decode's KV holds the WHOLE chunked context, not
                # just its direct dep's piece
                cd.payload["kv_ctx"] = int(col.context(v)) + q_tokens
            else:
                add(dag, N(col.chat_prefill), col.chat_prefill,
                    "stream_prefill", int(col.context(v)) + q_tokens,
                    deps=refine_tails + gate_ids, template=col.chat_prefill)
                add(dag, N(col.chat_decode), col.chat_decode, "stream_decode",
                    int(col.answer(v)), deps=[N(col.chat_prefill)],
                    template=col.chat_decode)
        return dag

    def _wire_group(self, dag, g: BranchGroup, v: View, N, add,
                    add_branch_refine, fine_grained: bool):
        count = int(g.count(v))
        src = dag.nodes[N(g.source)]
        per_piece = max(src.workload // max(count, 1), 1)
        state = {"done": 0, "spawned": 0}

        def spawn(d: DynamicDAG, i: int, dep_id: str):
            prev = dep_id
            for bs in g.stages:
                deps = []
                for dep in bs.deps:
                    if dep == "$source":
                        deps.append(dep_id)
                    elif dep == "$prev":
                        deps.append(prev)
                    else:
                        deps.append(N(dep))
                node = add(d, N(bs.id.format(i=i)), bs.stage, bs.kind,
                           max(int(bs.workload(v)), 1), deps=deps,
                           template=bs.template,
                           coalescable=bs.coalescable)
                prev = node.id
            if g.to_collector and self.collector is not None:
                add_branch_refine(d, g.label.format(i=i), prev)

        def expander(d: DynamicDAG, node: Node):
            while state["spawned"] < count:
                spawn(d, state["spawned"], node.id)
                state["spawned"] += 1

        src.expander = expander
        if g.progressive:
            def on_progress(d: DynamicDAG, piece: Node, tokens_done: int):
                state["done"] += tokens_done
                while (state["spawned"] < count
                       and state["done"] >= (state["spawned"] + 1)
                       * per_piece):
                    spawn(d, state["spawned"], piece.id)
                    state["spawned"] += 1

            src.payload["on_progress"] = on_progress

    # -- template derivation (Eq. 4 prior) -----------------------------------
    def build_template(self, means) -> WorkflowTemplate:
        """Derive the future-criticality prior from the SAME spec.  ``means``
        is a historical-means dict (``default_means``) or any trace-like
        object exposing the spec's workload fields."""
        v = View.of(means)
        t = WorkflowTemplate()
        tid_of = {s.id: s.tid for s in self.statics}

        def mw(spec_stage) -> float:
            fn = spec_stage.mean_workload or spec_stage.workload
            return float(fn(v))

        for s in self.statics:
            deps = s.template_deps if s.template_deps is not None else s.deps
            t.add_stage(s.tid, s.stage, s.kind, mw(s), 1.0,
                        deps=[tid_of.get(d, d) for d in deps])
        for g in self.groups:
            prev_t = tid_of[g.source]
            for bs in g.stages:
                deps = (bs.template_deps if bs.template_deps is not None
                        else bs.deps)
                mapped = []
                for dep in deps:
                    if dep == "$source":
                        mapped.append(tid_of[g.source])
                    elif dep == "$prev":
                        mapped.append(prev_t)
                    else:
                        mapped.append(tid_of.get(dep, dep))
                t.add_stage(bs.template, bs.stage, bs.kind, mw(bs),
                            float(g.count(v)), deps=mapped)
                prev_t = bs.template
        col = self.collector
        if col is not None:
            n_sources = 1.0 + sum(float(g.count(v)) for g in self.groups
                                  if g.to_collector)
            ctx_piece = max(float(col.context(v)) / n_sources, col.ctx_floor)
            ref_piece = max(float(col.refine_out(v)) / n_sources,
                            col.refine_floor)
            refine_deps = [tid_of[col.base_dep]] + [
                g.stages[-1].template for g in self.groups if g.to_collector]
            t.add_stage(col.refine_prefill, col.refine_prefill,
                        "stream_prefill", ctx_piece, n_sources,
                        deps=refine_deps)
            t.add_stage(col.refine_decode, col.refine_decode, "stream_decode",
                        ref_piece, n_sources, deps=[col.refine_prefill])
            t.add_stage(col.chat_prefill, col.chat_prefill, "stream_prefill",
                        ctx_piece + float(col.query(v)), n_sources,
                        deps=[col.refine_decode])
            t.add_stage(col.chat_decode, col.chat_decode, "stream_decode",
                        float(col.answer(v)), 1.0, deps=[col.chat_prefill])
        return t


# ---------------------------------------------------------------------------
# builtin specs: the paper's W1-W3 (§6.1)
# ---------------------------------------------------------------------------

def _retrieval_statics(base: bool) -> List[StageSpec]:
    """chunk-embedding + query-embedding + vector search + rerank."""
    sfx = "_base" if base else ""
    return [
        StageSpec("embed_chunks", "embed", "batchable",
                  lambda v: v.n_chunks, role="embed"),
        StageSpec("embed_query", "embed", "batchable", _ONE, role="embed"),
        StageSpec(f"vsearch{sfx}", "vsearch", "search",
                  lambda v: v.n_chunks * 8,
                  deps=("embed_chunks", "embed_query"),
                  template="vsearch", role="search"),
        StageSpec(f"rerank{sfx}", "rerank", "batchable", lambda v: v.rerank,
                  deps=(f"vsearch{sfx}",), template="rerank", role="rerank"),
    ]


def w1_spec() -> WorkflowSpec:
    """W1 Fast Document Finder: chunk→embed→index→retrieve→rerank→generate."""
    statics = _retrieval_statics(base=False) + [
        StageSpec("chat_prefill", "chat_prefill", "stream_prefill",
                  lambda v: v.context_tokens + v.query_tokens,
                  deps=("rerank",), role="chat",
                  shared_ctx=lambda v: v.context_tokens),
        StageSpec("chat_decode", "chat_decode", "stream_decode",
                  lambda v: v.answer_tokens, deps=("chat_prefill",),
                  role="chat"),
    ]
    return WorkflowSpec("w1", tuple(statics))


def _subquery_group() -> BranchGroup:
    """The rewriter's dynamic sub-query branches (progressive release)."""
    return BranchGroup(
        source="rewrite_decode", count=lambda v: v.n_subqueries,
        label="sq{i}", progressive=True,
        stages=(
            BranchStage("embed_sq{i}", "embed", "batchable", _ONE,
                        deps=("$source",), template="embed_sq"),
            BranchStage("vsearch_sq{i}", "vsearch", "search",
                        lambda v: v.n_chunks * 8,
                        deps=("$prev", "embed_chunks"),
                        template="vsearch_sq", template_deps=("$prev",)),
            BranchStage("rerank_sq{i}", "rerank", "batchable",
                        lambda v: max(v.rerank // 2, 4),
                        mean_workload=lambda v: v.rerank / 2,
                        deps=("$prev",), template="rerank_sq"),
        ))


def _web_group() -> BranchGroup:
    """The planner's web-search branches (spawned on plan completion)."""
    return BranchGroup(
        source="plan_decode", count=lambda v: v.n_web, label="web{i}",
        progressive=False,
        stages=(
            BranchStage("web{i}", "web", "io", _ONE, deps=("$source",),
                        template="web", role="io"),
            BranchStage("embed_web{i}", "embed", "batchable", lambda v: 4,
                        deps=("$prev",), template="embed_web"),
        ))


def _agentic_spec(name: str, planner: bool) -> WorkflowSpec:
    statics = _retrieval_statics(base=True) + [
        StageSpec("rewrite_prefill", "rewrite_prefill", "stream_prefill",
                  lambda v: v.query_tokens, role="search_llm"),
        StageSpec("rewrite_decode", "rewrite_decode", "stream_decode",
                  lambda v: v.rewrite_tokens, deps=("rewrite_prefill",),
                  role="search_llm"),
    ]
    groups = [_subquery_group()]
    if planner:
        statics += [
            StageSpec("plan_prefill", "plan_prefill", "stream_prefill",
                      lambda v: v.query_tokens, role="search_llm"),
            StageSpec("plan_decode", "plan_decode", "stream_decode",
                      lambda v: v.plan_tokens, deps=("plan_prefill",),
                      role="search_llm"),
        ]
        groups.append(_web_group())
    return WorkflowSpec(name, tuple(statics), tuple(groups),
                        CollectorSpec(base_dep="rerank_base"))


def w2_spec() -> WorkflowSpec:
    """W2 Advanced Document QA: + LLM query rewriting + per-branch refine."""
    return _agentic_spec("w2", planner=False)


def w3_spec() -> WorkflowSpec:
    """W3 Deep Researcher: + search planner issuing web requests."""
    return _agentic_spec("w3", planner=True)


_BUILTINS: Dict[int, Callable[[], WorkflowSpec]] = {
    1: w1_spec, 2: w2_spec, 3: w3_spec}


def builtin_spec(wf) -> WorkflowSpec:
    """The paper's workflow ``wf`` as a WorkflowSpec: 1/2/3 or the
    equivalent "w1"/"w2"/"w3" names (what mixed-workflow benchmark
    configs and CLI flags pass around)."""
    if isinstance(wf, str):
        wf = int(wf.lower().lstrip("w"))
    return _BUILTINS[wf]()
