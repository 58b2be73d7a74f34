"""Speculative-decoding primitives shared by the scheduler, the perf
model and both backends.

Speculation splits every decode round into a coupled (draft, verify)
pair: a small draft model streams ``w`` candidate tokens per verify
pass while the target model scores the previous group of ``w + 1``
positions in ONE weight sweep (the spec win — the sweep is what a
memory-bound decode pays per token).  With accept rate ``alpha`` a
verify pass lands ``1 + alpha*w`` tokens on average, so a token group
of ``g`` needs ``ceil(g / (1 + alpha*w))`` passes instead of ``g``
steps.

This module is a leaf (no repro imports): naming conventions for the
paired draft stages, the pass-count arithmetic, and the online
accept-rate tracker (:class:`SpecTracker`) whose totals are the
backend-independent ``drafted_tokens`` / ``accepted_tokens`` counters
surfaced on :class:`~repro_torch.api.backends.BackendRun`.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

# draft stages are named by convention off their verify stage:
# "chat_decode" -> "chat_draft" (see rag.stages.build_stages, which
# appends one draft StageModel per decode stage from the draft config)
DRAFT_SUFFIX = "_draft"
VERIFY_SUFFIX = "_decode"

# the in-tree small config the draft stages are built from (the only
# sub-1B config shipped; SessionOptions.draft_model validates against
# the registry in rag.stages.DRAFT_MODELS)
DEFAULT_DRAFT_MODEL = "qwen1p5_0p5b"


def draft_stage_of(verify_stage: str) -> Optional[str]:
    """Perf-stage name of the draft companion of ``verify_stage``
    (``None`` when the stage is not a ``*_decode`` verify target —
    including draft stages themselves, which never recurse)."""
    if not verify_stage.endswith(VERIFY_SUFFIX):
        return None
    return verify_stage[: -len(VERIFY_SUFFIX)] + DRAFT_SUFFIX


def is_draft_stage(stage: str) -> bool:
    return stage.endswith(DRAFT_SUFFIX)


def spec_passes(group: int, draft_width: int, alpha: float) -> int:
    """Expected verify passes to land a ``group``-token round when every
    pass drafts ``draft_width`` candidates at accept rate ``alpha``:
    ``ceil(g / (1 + alpha*w))``, never above ``g`` (alpha = 0 degrades
    to plain one-token-per-pass decode) and never below 1."""
    g = max(int(group), 1)
    w = max(int(draft_width), 0)
    per = 1.0 + max(min(float(alpha), 1.0), 0.0) * w
    return max(1, min(g, math.ceil(g / per)))


class SpecTracker:
    """Online accept-rate state + run totals (counter protocol).

    Per-stream accept rate is an EWMA over observed per-round accept
    fractions — streams differ (a rewriter's constrained output drafts
    better than open chat), and the scheduler prices each round with
    the stream's own ``alpha``.  Run totals follow the kv-tracker
    pattern: both backends read ``drafted_tokens`` / ``accepted_tokens``
    off the scheduler's tracker, and per-node payload stamps sum to the
    same totals (the ``preemptions`` contract)."""

    def __init__(self, init: float = 0.6, weight: float = 0.3):
        self.init = float(init)
        self.weight = float(weight)
        self._alpha: Dict[str, float] = {}
        self.drafted_tokens = 0
        self.accepted_tokens = 0
        self.rounds = 0

    def alpha(self, key: str, init: Optional[float] = None) -> float:
        """Current accept-rate estimate for one decode stream.  ``init``
        overrides the tracker-wide prior for streams never observed —
        the scheduler passes the profiled pair prior when the perf model
        has one."""
        return self._alpha.get(key, self.init if init is None else init)

    def observe(self, key: str, drafted: int, accepted: int) -> None:
        """Fold one round's accept counts into the stream's EWMA and the
        run totals.  ``accepted`` is clamped into [0, drafted]."""
        if drafted <= 0:
            return
        accepted = max(0, min(int(accepted), int(drafted)))
        self.drafted_tokens += int(drafted)
        self.accepted_tokens += accepted
        self.rounds += 1
        r = accepted / drafted
        prev = self._alpha.get(key, self.init)
        self._alpha[key] = (1.0 - self.weight) * prev + self.weight * r

    @property
    def accept_rate(self) -> float:
        """Run-wide observed accept fraction (0 when nothing drafted)."""
        if self.drafted_tokens <= 0:
            return 0.0
        return self.accepted_tokens / self.drafted_tokens
