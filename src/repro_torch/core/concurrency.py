"""Bandwidth-aware concurrency control (paper §4.2, Eq. 5).

Admitting ready node v with config c while the critical-path node v* runs
costs:  W_B = φ_{v*}(B(t) + b_v(c)) · (t − S_{v*}) · p_{v*}(c_{v*}).
A soft budget B_soft prunes configs outright.  The mapper's final score is
F_v(c) + α · W_B  (Alg. 1 line 13) — parallelism is admitted only when it
does not significantly impede critical-path progress.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.core.dag import RUNNING, Node
from repro_torch.core.perf_model import LinearPerfModel


def contention_penalty(perf: LinearPerfModel, v_star: Optional[Node],
                       b_cand: float, B_now: float, now: float) -> float:
    """W_B (Eq. 5).  0 when there is no running critical node."""
    if v_star is None or v_star.status != RUNNING or v_star.config is None:
        return 0.0
    pu, batch = v_star.config
    if pu == "io":                 # external calls consume no bandwidth
        return 0.0
    p_star = perf.p0(v_star.stage, pu, batch)
    phi = perf.phi(v_star.stage, B_now + b_cand)
    active = max(now - v_star.start, 0.0)
    return phi * active * p_star


def violates_budget(B_now: float, b_cand: float, b_soft: float) -> bool:
    """Soft bandwidth constraint (Alg. 1 line 11)."""
    return B_now + b_cand > b_soft
