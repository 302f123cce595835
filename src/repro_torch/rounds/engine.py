"""Segmented round engine (counterpart of ``repro.rounds.engine``).

Torch has no ``lax.scan``: the reference's scanned round program becomes,
in the port, a Python loop over a segment's rounds.  What the engine keeps
from the reference is the contract around it: every per-round host
decision is resolved up front into (R, ...) operands, the per-round
metrics stay on the device, and they reach the host in ONE transfer at
the end of the run (:meth:`RoundEngine.run`).  :meth:`RoundEngine.run_loop`
is the per-round baseline: the same body, its metrics fetched after every
round.

Segments (:func:`split_segments`) bound how many rounds run between two
host hooks (``on_boundary`` / ``on_segment``); eval rounds become segment
``boundaries``.  A resumed run (``start``) must start on a segment
boundary.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Iterable, Optional

import numpy as np
import torch

from repro_torch.obs import runtime as obs_runtime
from repro_torch.tree import tree_leaves, tree_map

PyTree = Any

#: ``chunk`` value meaning "the whole run is one segment".
WHOLE_RUN = None


def split_segments(rounds: int, chunk: Optional[int] = None,
                   boundaries: Iterable[int] = ()) -> list[tuple[int, int]]:
    """``[start, end)`` segments covering ``range(rounds)``: at most
    ``chunk`` rounds each (``None`` = unbounded), also cut at every round
    index in ``boundaries`` (out-of-range ones are ignored)."""
    if rounds < 0:
        raise ValueError(f"rounds must be >= 0, got {rounds}")
    if chunk is not None and chunk <= 0:
        raise ValueError(f"chunk must be positive or None, got {chunk}")
    cuts = sorted({b for b in boundaries if 0 < b < rounds} | {rounds})
    segs: list[tuple[int, int]] = []
    start = 0
    for cut in cuts:
        while start < cut:
            end = cut if chunk is None else min(start + chunk, cut)
            segs.append((start, end))
            start = end
    return segs


def _leading_dim(operands: PyTree) -> int:
    leaves = tree_leaves(operands)
    if not leaves:
        raise ValueError("operands pytree has no leaves")
    n = np.shape(leaves[0])[0]
    for leaf in leaves:
        if np.shape(leaf)[0] != n:
            raise ValueError("operand leaves disagree on the round axis: "
                             f"{np.shape(leaf)[0]} vs {n}")
    return n


def _sync(state: PyTree) -> None:
    """Wait for the device of the state's first CUDA tensor, if any."""
    for leaf in tree_leaves(state):
        if isinstance(leaf, torch.Tensor) and leaf.device.type == "cuda":
            torch.cuda.synchronize(leaf.device)
            return


def fetch_metrics(per_round: list) -> dict:
    """Per-round metric dicts -> ``{name: (R, ...) numpy array}``: tensor
    metrics are stacked on their device, Python numbers (a host-side
    learning rate) as they are, then :func:`fetch_columns`."""
    cols: dict = {}
    for k in per_round[0]:
        vals = [m[k] for m in per_round]
        cols[k] = torch.stack(vals) if isinstance(vals[0], torch.Tensor) \
            else np.asarray(vals)
    return fetch_columns(cols)


def fetch_columns(cols: dict) -> dict:
    """Metric columns -> numpy: the device tensors are copied to the host
    in ONE transfer (widened to float64, exact for fp32, int32 and bool,
    and cast back); anything else passes through."""
    on_dev = {k: c for k, c in cols.items() if isinstance(c, torch.Tensor)}
    out = dict(cols)
    if on_dev:
        flat = torch.cat([c.double().reshape(-1) for c in on_dev.values()]
                         ).cpu().numpy()
        off = 0
        for k, c in on_dev.items():
            dtype = torch.empty((), dtype=c.dtype).numpy().dtype
            out[k] = flat[off:off + c.numel()].reshape(tuple(c.shape)
                                                       ).astype(dtype)
            off += c.numel()
    return out


class RoundEngine:
    """Drives ``body(state, op) -> (state, metrics)`` segment by segment.

    ``op`` is one round's slice of the operand pytree (its leading round
    axis stripped); ``prepare`` (optional) turns a segment's host slice
    into what the body reads (e.g. one host-to-device copy per leaf a
    segment).  Counters, as the reference's:

    * ``trace_count`` — builds of the segment program: one per engine, on
      its first run (the port traces nothing; a rerun builds nothing, so
      a second run with the same skeleton adds 0);
    * ``chunk_shapes`` — the segment lengths run;
    * ``transfer_count`` — host metric fetches (one per :meth:`run`, one
      per round in :meth:`run_loop`);
    * ``segment_log`` — ``(start, end, seconds)`` of the latest run's
      segments, by the host clock around the segment's rounds and a
      device synchronize at its end (which transfers nothing).
    """

    def __init__(self, body: Callable, *, chunk: Optional[int] = WHOLE_RUN,
                 prepare: Optional[Callable[[PyTree], PyTree]] = None):
        self.body = body
        self.chunk = chunk
        self.prepare = prepare
        self.trace_count = 0
        self.chunk_shapes: set[int] = set()
        self.transfer_count = 0
        self.segment_log: list[tuple[int, int, float]] = []
        self._built = False

    def _build(self) -> None:
        if not self._built:
            self._built = True
            self.trace_count += 1
            obs_runtime.event("rounds.trace", trace_count=self.trace_count)

    def _slice(self, operands: PyTree, start: int, end: int) -> PyTree:
        seg = tree_map(lambda a: a[start:end], operands)
        return self.prepare(seg) if self.prepare is not None else seg

    @staticmethod
    def _skip_to(segs: list[tuple[int, int]], start: int,
                 rounds: int) -> list[tuple[int, int]]:
        """Drop the segments a resumed run already executed.  ``start``
        must land exactly on a segment boundary: anything else means the
        plan changed under the snapshot."""
        if start == 0:
            return segs
        valid = {0, *(e for _, e in segs)}
        if start not in valid:
            raise ValueError(
                f"resume start {start} is not a segment boundary of this "
                f"plan (valid: {sorted(valid)}); the chunk/boundary "
                "schedule differs from the one that wrote the snapshot")
        return [(s, e) for s, e in segs if e > start]

    def run(self, state: PyTree, operands: PyTree, *,
            boundaries: Iterable[int] = (),
            on_boundary: Optional[Callable[[int, PyTree], None]] = None,
            on_segment: Optional[Callable[[int, int, PyTree, list],
                                          None]] = None,
            start: int = 0) -> tuple[PyTree, Optional[dict]]:
        """Runs rounds ``[start, R)``; returns (final state, host metrics).

        ``on_boundary(end, state)`` fires after every segment;
        ``on_segment(start, end, state, metrics)`` after it, with the
        segment's per-round DEVICE metrics.  Metrics come back as
        ``{name: (R - start, ...) numpy}``, fetched in one transfer per
        run; ``None`` when no rounds remain."""
        rounds = _leading_dim(operands)
        segs = self._skip_to(split_segments(rounds, self.chunk, boundaries),
                             start, rounds)
        self._build()
        self.segment_log = []
        per_round: list = []
        for seg_start, end in segs:
            self.chunk_shapes.add(end - seg_start)
            t0 = time.perf_counter()
            with obs_runtime.span("rounds.segment", start=seg_start, end=end):
                seg = self._slice(operands, seg_start, end)
                seg_metrics = []
                for i in range(end - seg_start):
                    state, metrics = self.body(
                        state, tree_map(lambda a, i=i: a[i], seg))
                    seg_metrics.append(metrics)
                _sync(state)
            self.segment_log.append((seg_start, end,
                                     time.perf_counter() - t0))
            per_round.extend(seg_metrics)
            if on_boundary is not None:
                on_boundary(end, state)
            if on_segment is not None:
                on_segment(seg_start, end, state, seg_metrics)
        if not per_round:
            return state, None
        self.transfer_count += 1
        obs_runtime.inc("rounds.transfers")
        return state, fetch_metrics(per_round)

    def run_loop(self, state: PyTree, operands: PyTree, *,
                 boundaries: Iterable[int] = (),
                 on_boundary: Optional[Callable[[int, PyTree], None]] = None,
                 start: int = 0) -> tuple[PyTree, Optional[dict]]:
        """The per-round baseline: the same body, each round's operands
        prepared alone and its metrics fetched at once.  Honours the same
        boundary hook and resume ``start`` as :meth:`run`."""
        rounds = _leading_dim(operands)
        segs = self._skip_to(split_segments(rounds, self.chunk, boundaries),
                             start, rounds)
        stops = {end for _, end in segs}
        per_round: list = []
        for r in range(start, rounds):
            op = tree_map(lambda a: a[0], self._slice(operands, r, r + 1))
            state, metrics = self.body(state, op)
            self.transfer_count += 1
            obs_runtime.inc("rounds.transfers")
            per_round.append(fetch_metrics([metrics]))
            if on_boundary is not None and (r + 1) in stops:
                on_boundary(r + 1, state)
        if not per_round:
            return state, None
        return state, {k: np.concatenate([m[k] for m in per_round])
                       for k in per_round[0]}
