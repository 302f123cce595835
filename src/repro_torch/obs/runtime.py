"""Process-wide runtime event registry: counters + timestamped spans
(counterpart of ``repro.obs.runtime``, pure Python).

The fleet runner, the round engine and the fed server emit **instant
events** (:func:`event`), **spans** (:func:`span`, wall-clock begin /
duration) and **counters** (:func:`inc`) into one bounded ring,
queryable as :func:`history` and :func:`counters`.
Emission is on the host only; the ring holds the newest ``capacity``
events.  :func:`now` is the ring's clock and :func:`span_at` records a
span whose endpoints were taken earlier (the fleet service's submit ->
done job spans).  The kernel dispatch record is re-exported at the
bottom, so this module is the one place to query.  The reference's
exporters (JSONL, Chrome trace) wait for a ported caller (ROADMAP queue
1, item 10).
"""
from __future__ import annotations

import time
from collections import deque
from contextlib import contextmanager
from typing import Any, Iterator, Optional

#: Default ring capacity (events, not bytes).
DEFAULT_CAPACITY = 4096


class Runtime:
    """One bounded event ring + counter table."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self.reset(capacity)

    def _now(self) -> float:
        return time.perf_counter() - self._epoch

    def now(self) -> float:
        """Seconds since the registry epoch: the timebase of every event's
        ``ts``.  Callers keep it to record, later, a span whose endpoints
        they learn after the fact (:meth:`span_at`)."""
        return self._now()

    def _append(self, ev: dict) -> None:
        self._seq += 1
        ev["seq"] = self._seq
        self._events.append(ev)

    # -- emission ---------------------------------------------------------
    def event(self, name: str, **args: Any) -> dict:
        """Record an instant event; returns the (live) event dict."""
        ev = {"name": name, "kind": "instant", "ts": self._now(),
              "dur": None, "args": args}
        self._append(ev)
        return ev

    @contextmanager
    def span(self, name: str, **args: Any) -> Iterator[dict]:
        """Record a wall-clock span around a ``with`` block.  The event is
        appended at EXIT (so ``dur`` is final); ``ts`` is the entry time."""
        t0 = self._now()
        ev = {"name": name, "kind": "span", "ts": t0, "dur": None,
              "args": args}
        try:
            yield ev
        finally:
            ev["dur"] = self._now() - t0
            self._append(ev)

    def span_at(self, name: str, start: float, end: Optional[float] = None,
                **args: Any) -> dict:
        """Record a span with explicit endpoints (values of :meth:`now`);
        ``end=None`` means now."""
        t1 = self._now() if end is None else end
        ev = {"name": name, "kind": "span", "ts": start,
              "dur": max(t1 - start, 0.0), "args": args}
        self._append(ev)
        return ev

    def inc(self, name: str, value: float = 1.0) -> float:
        """Bump a monotone counter; returns the new value."""
        new = self._counters.get(name, 0.0) + value
        self._counters[name] = new
        return new

    # -- querying ---------------------------------------------------------
    def history(self, *, limit: Optional[int] = None,
                name: Optional[str] = None,
                kind: Optional[str] = None) -> list[dict]:
        """Most recent events, oldest first, optionally filtered by exact
        ``name`` and/or ``kind`` ("instant" | "span")."""
        evs = list(self._events)
        if name is not None:
            evs = [e for e in evs if e["name"] == name]
        if kind is not None:
            evs = [e for e in evs if e["kind"] == kind]
        return evs if limit is None else evs[-limit:]

    def counters(self) -> dict[str, float]:
        return dict(self._counters)

    def reset(self, capacity: Optional[int] = None) -> None:
        """Drop all events and counters; restart the clock."""
        if capacity is not None:
            self._capacity = capacity
        self._events: deque = deque(maxlen=self._capacity)
        self._counters: dict[str, float] = {}
        self._epoch = time.perf_counter()
        self._seq = 0                   # lifetime emitted (ring may drop)


# ---------------------------------------------------------------------------
# The process singleton + module-level facade (what callers import).
# ---------------------------------------------------------------------------

_RUNTIME = Runtime()


def event(name: str, **args: Any) -> dict:
    return _RUNTIME.event(name, **args)


def span(name: str, **args: Any):
    return _RUNTIME.span(name, **args)


def span_at(name: str, start: float, end: Optional[float] = None,
            **args: Any) -> dict:
    return _RUNTIME.span_at(name, start, end, **args)


def now() -> float:
    return _RUNTIME.now()


def inc(name: str, value: float = 1.0) -> float:
    return _RUNTIME.inc(name, value)


def history(*, limit: Optional[int] = None, name: Optional[str] = None,
            kind: Optional[str] = None) -> list[dict]:
    return _RUNTIME.history(limit=limit, name=name, kind=kind)


def counters() -> dict[str, float]:
    return _RUNTIME.counters()


def reset(capacity: Optional[int] = None) -> None:
    _RUNTIME.reset(capacity=capacity)


# ---------------------------------------------------------------------------
# Kernel dispatch re-exports: this module is the query surface; the record
# lives with its owner, repro_torch.kernels.dispatch.
# ---------------------------------------------------------------------------

from repro_torch.kernels.dispatch import (   # noqa: E402  (tail import)
    DispatchRecord, KernelDecision, last_dispatch,
)

__all__ = [
    "DEFAULT_CAPACITY", "Runtime", "event", "span", "span_at", "now", "inc",
    "history", "counters", "reset", "DispatchRecord", "KernelDecision",
    "last_dispatch",
]
