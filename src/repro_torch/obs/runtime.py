"""Process-wide runtime event registry: counters + timestamped spans
(counterpart of ``repro.obs.runtime``, pure Python).

The fleet runner, the round engine, the fed server, the snapshot store
and the aggregation's dispatch record (``kernels.dispatch`` events) emit
**instant events** (:func:`event`), **spans** (:func:`span`, wall-clock
begin / duration) and **counters** (:func:`inc`) into one bounded ring,
queryable as :func:`history` and :func:`counters` and exportable as JSONL
(:func:`export_jsonl`, read back by :func:`import_jsonl`) or the Chrome
trace-event format (:func:`export_chrome_trace`, loadable in Perfetto or
``chrome://tracing``).  Emission is on the host only and stores its
arguments as they are; :func:`snapshot` and the exporters turn them into
JSON values (dataclasses into dicts, 0-d tensors and numpy scalars into
Python numbers), so emitting never synchronises the device.  The ring
holds the newest ``capacity`` events.  :func:`now` is the ring's clock
and :func:`span_at` records a span whose endpoints were taken earlier
(the fleet service's submit -> done job spans).  The kernel dispatch
record is re-exported at the bottom, so this module is the one place to
query.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from collections import deque
from contextlib import contextmanager
from typing import Any, Iterator, Optional

#: Default ring capacity (events, not bytes).
DEFAULT_CAPACITY = 4096


def _sanitize(value: Any) -> Any:
    """JSON-able deep copy: dataclasses -> dicts, 0-d tensors and numpy
    scalars -> Python numbers, anything else -> ``str``."""
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        return _sanitize(dataclasses.asdict(value))
    if isinstance(value, dict):
        return {str(k): _sanitize(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_sanitize(v) for v in value]
    if value is None or isinstance(value, (bool, int, float, str)):
        return value
    item = getattr(value, "item", None)     # a 0-d tensor or numpy scalar
    if item is not None and getattr(value, "ndim", None) in (0, None):
        try:
            return _sanitize(item())
        except (TypeError, ValueError, RuntimeError):
            pass
    return str(value)


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

    def snapshot(self) -> list[dict]:
        """JSON-able copy of the whole ring, oldest first."""
        return [dict(e, args=_sanitize(e["args"])) for e in self.history()]

    def reset(self, capacity: Optional[int] = None) -> None:
        """Drop all events and counters; restart the clock."""
        if capacity is not None:
            self._capacity = capacity
        self._events: deque = deque(maxlen=self._capacity)
        self._counters: dict[str, float] = {}
        self._epoch = time.perf_counter()
        self._seq = 0                   # lifetime emitted (ring may drop)

    # -- exporters --------------------------------------------------------
    def export_jsonl(self, path: str) -> int:
        """One JSON object per line: every ring event (as
        :meth:`snapshot` gives it), then one ``kind="counter"`` line per
        counter.  Returns the line count."""
        events = self.snapshot()
        counters = self.counters()
        now = self._now()
        with open(path, "w") as fh:
            for ev in events:
                fh.write(json.dumps(ev, sort_keys=True) + "\n")
            for cname in sorted(counters):
                fh.write(json.dumps(
                    {"name": cname, "kind": "counter", "ts": now,
                     "value": counters[cname]}, sort_keys=True) + "\n")
        return len(events) + len(counters)

    def export_chrome_trace(self, path: str) -> int:
        """Chrome trace-event JSON: spans as complete ("X") events,
        instants as "i", each counter as one "C" sample.  Timestamps are
        microseconds since the registry epoch, in nondecreasing order.
        Returns the event count."""
        pid = os.getpid()
        rows = []
        for ev in self.snapshot():
            row = {"name": ev["name"], "pid": pid, "tid": 0,
                   "ts": ev["ts"] * 1e6, "args": ev["args"]}
            if ev["kind"] == "span":
                row["ph"] = "X"
                row["dur"] = (ev["dur"] or 0.0) * 1e6
            else:
                row["ph"] = "i"
                row["s"] = "p"
            rows.append(row)
        now_us = self._now() * 1e6
        for cname, val in sorted(self.counters().items()):
            rows.append({"name": cname, "ph": "C", "pid": pid, "tid": 0,
                         "ts": now_us, "args": {"value": val}})
        rows.sort(key=lambda r: r["ts"])
        with open(path, "w") as fh:
            json.dump({"traceEvents": rows, "displayTimeUnit": "ms"}, fh)
        return len(rows)


def import_jsonl(path: str) -> list[dict]:
    """Parse an :func:`export_jsonl` file back into its line dicts."""
    out = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


# ---------------------------------------------------------------------------
# The process singleton + module-level facade (what callers import).
# ---------------------------------------------------------------------------

_RUNTIME = Runtime()


def get_runtime() -> Runtime:
    return _RUNTIME


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


def snapshot() -> list[dict]:
    return _RUNTIME.snapshot()


def reset(capacity: Optional[int] = None) -> None:
    _RUNTIME.reset(capacity=capacity)


def export_jsonl(path: str) -> int:
    return _RUNTIME.export_jsonl(path)


def export_chrome_trace(path: str) -> int:
    return _RUNTIME.export_chrome_trace(path)


# ---------------------------------------------------------------------------
# Kernel dispatch re-exports: this module is the query surface; the record
# lives with its owner, repro_torch.kernels.dispatch.
# ---------------------------------------------------------------------------

from repro_torch.kernels.dispatch import (   # noqa: E402  (tail import)
    DispatchRecord, KernelDecision, dispatch_history, last_dispatch,
)

__all__ = [
    "DEFAULT_CAPACITY", "Runtime", "get_runtime", "event", "span", "span_at",
    "now", "inc", "history", "counters", "snapshot", "reset",
    "export_jsonl", "export_chrome_trace", "import_jsonl",
    "DispatchRecord", "KernelDecision", "dispatch_history", "last_dispatch",
]
