"""Opt-in runtime invariant checks, gated by ``REPRO_CHECK=1``.

The scheduler core carries invariants that hold by construction but
that nothing re-verifies at runtime — most importantly KV-residency
quiescence: once a run drains, every tracked stream has been released
and (for the monolithic tracker) total resident bytes are back to zero;
for the paged store, no page is still pinned and every tier's
accounting is self-consistent.

Checks cost time on hot paths, so they are off by default and enabled
by the ``REPRO_CHECK=1`` environment variable — tests and the CI
bench-smoke legs run with it set, production benchmarking does not.
A failed check raises :class:`InvariantError` (never a silent log), so
CI turns an accounting leak into a red job instead of a drifting
counter.
"""
from __future__ import annotations

import os


class InvariantError(AssertionError):
    """A ``REPRO_CHECK``-guarded runtime invariant was violated."""


def enabled() -> bool:
    """True when ``REPRO_CHECK`` is set to a truthy value."""
    return os.environ.get("REPRO_CHECK", "") not in ("", "0", "false",
                                                     "False")


def invariant(cond: bool, message: str) -> None:
    """Raise :class:`InvariantError` unless ``cond`` (checks enabled
    only — callers guard the *computation* of ``cond`` with
    :func:`enabled` themselves when it is expensive)."""
    if not cond:
        raise InvariantError(message)
