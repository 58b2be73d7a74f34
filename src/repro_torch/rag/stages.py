"""Stage catalogs: map a model family (configs.get_family) to the perf-model
StageModel dict + the role map used by baseline static mappings."""
from __future__ import annotations

from typing import Dict, Optional

from repro_torch.configs import ModelConfig
from repro_torch.configs.qwen1p5_0p5b import CONFIG as _QWEN1P5_0P5B
from repro_torch.core.perf_model import StageModel
from repro_torch.core.spec_decode import DEFAULT_DRAFT_MODEL, draft_stage_of

# registry of in-tree draft-model configs SessionOptions.draft_model
# validates against (small enough to propose tokens the target verifies
# in one sweep; the only sub-1B config shipped today)
DRAFT_MODELS: Dict[str, ModelConfig] = {
    "qwen1p5_0p5b": _QWEN1P5_0P5B,
}


def _kv_bytes_token(cfg: ModelConfig, bytes_per_param: float = 1.0) -> float:
    """K+V cache bytes per context token (GQA): 2 · layers · kv_heads ·
    head_dim · bytes — what KV-residency tracking and the migration-cost
    model charge per resident token."""
    return (2.0 * cfg.num_layers * cfg.num_kv_heads * cfg.resolved_head_dim
            * bytes_per_param)


def kv_page_bytes(cfg: ModelConfig, page_tokens: int = 64,
                  bytes_per_param: float = 1.0) -> float:
    """Bytes of one paged-KV page for this model's cache shape — the unit
    the tiered page store allocates, demotes and fetches in
    (``SchedulerConfig.kv_page_tokens`` × the GQA bytes/token above)."""
    return page_tokens * _kv_bytes_token(cfg, bytes_per_param)


def build_stages(family: Dict[str, ModelConfig],
                 draft_model: Optional[str] = DEFAULT_DRAFT_MODEL
                 ) -> Dict[str, StageModel]:
    e, r = family["embed"], family["rerank"]
    s, c = family["search"], family["chat"]
    kv_s, kv_c = _kv_bytes_token(s), _kv_bytes_token(c)
    stages = {
        "embed": StageModel("embed", e.param_count(), e.d_model,
                            "batchable", item_tokens=128),
        "rerank": StageModel("rerank", r.param_count(), r.d_model,
                             "batchable", item_tokens=160),
        "vsearch": StageModel("vsearch", 0, e.d_model, "search"),
        "rewrite_prefill": StageModel("rewrite_prefill", s.param_count(),
                                      s.d_model, "stream_prefill"),
        "rewrite_decode": StageModel("rewrite_decode", s.param_count(),
                                     s.d_model, "stream_decode",
                                     kv_bytes_token=kv_s),
        "plan_prefill": StageModel("plan_prefill", s.param_count(),
                                   s.d_model, "stream_prefill"),
        "plan_decode": StageModel("plan_decode", s.param_count(),
                                  s.d_model, "stream_decode",
                                  kv_bytes_token=kv_s),
        "refine_prefill": StageModel("refine_prefill", c.param_count(),
                                     c.d_model, "stream_prefill"),
        "refine_decode": StageModel("refine_decode", c.param_count(),
                                    c.d_model, "stream_decode",
                                    kv_bytes_token=kv_c),
        "chat_prefill": StageModel("chat_prefill", c.param_count(),
                                   c.d_model, "stream_prefill"),
        "chat_decode": StageModel("chat_decode", c.param_count(),
                                  c.d_model, "stream_decode",
                                  kv_bytes_token=kv_c),
        "web": StageModel("web", 0, 0, "io"),
    }
    # draft companions LAST: one small-model stream_decode stage per
    # verify (``*_decode``) stage, named by the spec_decode convention.
    # Appending after every existing entry keeps the perf-model fit's rng
    # stream byte-identical for the pre-spec stages (fit iterates in
    # insertion order), so spec_decode=False sessions stay bit-exact.
    if draft_model is not None:
        d = DRAFT_MODELS[draft_model]
        kv_d = _kv_bytes_token(d)
        for vname in [n for n, st in stages.items()
                      if st.kind == "stream_decode"]:
            dname = draft_stage_of(vname)
            stages[dname] = StageModel(dname, d.param_count(), d.d_model,
                                       "stream_decode", kv_bytes_token=kv_d)
    return stages


STAGE_ROLES: Dict[str, str] = {
    "embed": "embed", "rerank": "rerank", "vsearch": "search",
    "rewrite_prefill": "search_llm", "rewrite_decode": "search_llm",
    "plan_prefill": "search_llm", "plan_decode": "search_llm",
    "refine_prefill": "chat", "refine_decode": "chat",
    "chat_prefill": "chat", "chat_decode": "chat", "web": "io",
    # draft companions inherit their verify stage's role (static
    # strategies place them alongside the target they propose for)
    "rewrite_draft": "search_llm", "plan_draft": "search_llm",
    "refine_draft": "chat", "chat_draft": "chat",
}
