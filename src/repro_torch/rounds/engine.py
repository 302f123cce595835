"""Round segments (counterpart of ``repro.rounds.engine::split_segments``).

Torch has no ``lax.scan``: the reference's scanned round program becomes,
in the port, a Python loop over a segment's rounds whose metrics stay on
the device and reach the host once, at the segment's end.  This module
keeps the segment arithmetic that decides where those ends fall.
"""
from __future__ import annotations

from typing import Iterable, Optional

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
