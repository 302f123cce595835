"""RoundOptions: the shared "how do I execute rounds" knob set
(counterpart of ``repro.rounds.options``).

``None`` everywhere means "inherit": the surface's default for
``engine`` / ``chunk`` (whole-run segments), the config's own setting for
``taps`` and ``backend``, not resumable for ``checkpoint``, so
``RoundOptions()`` is a no-op and a partly filled object overlays any
config.  An explicitly
passed legacy keyword (``chunk=``) wins over the options object.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

#: Valid ``engine`` values (``None`` = the surface default, "scan").  The
#: port has no ``lax.scan``: a "scan" segment is a Python loop over its
#: rounds whose metrics reach the host once, at the segment's end.
ENGINES = ("scan", "loop")


@dataclasses.dataclass(frozen=True)
class RoundOptions:
    """Execution options shared by the round-driving surfaces.

    ``engine``  "scan" (segments of rounds, metrics fetched once per
                segment) or "loop"; the fleet runs segments only and
                refuses "loop".
    ``chunk``   segment length in rounds (``None`` = whole run, cut only
                at eval boundaries).
    ``taps``    force the in-round health taps on or off (``None`` = keep
                the config's ``taps``); bucket-key material in the fleet.
    ``backend`` force the aggregation backend ("torch" | "cuda" | "auto";
                ``None`` = keep ``AggregatorSpec.backend``).
    ``checkpoint`` a :class:`~repro_torch.resilience.CheckpointConfig` (or
                a bare directory path) making the run resumable: carry
                snapshots at segment boundaries, resume from the latest.
                ``None`` = not resumable.  Segments ("scan") only.  Typed
                loosely to keep this module free of import cycles.
    """
    engine: Optional[str] = None
    chunk: Optional[int] = None
    taps: Optional[bool] = None
    backend: Optional[str] = None
    checkpoint: Optional[Any] = None

    def __post_init__(self):
        if self.engine is not None and self.engine not in ENGINES:
            raise ValueError(
                f"engine must be one of {ENGINES} or None, got {self.engine!r}")
        if self.chunk is not None and self.chunk <= 0:
            raise ValueError(f"chunk must be positive or None, got {self.chunk}")

    def merged(self, *, engine: Optional[str] = None,
               chunk: Optional[int] = None, taps: Optional[bool] = None,
               backend: Optional[str] = None,
               checkpoint: Optional[Any] = None) -> "RoundOptions":
        """This object overlaid with explicitly passed legacy keywords."""
        return RoundOptions(
            engine=engine if engine is not None else self.engine,
            chunk=chunk if chunk is not None else self.chunk,
            taps=taps if taps is not None else self.taps,
            backend=backend if backend is not None else self.backend,
            checkpoint=checkpoint if checkpoint is not None
            else self.checkpoint)

    def apply_config(self, cfg):
        """``cfg`` (a TrainerConfig or FedConfig: anything with ``.taps``
        and ``.agg``) with the taps / backend overrides applied; the SAME
        object when nothing changes."""
        if self.taps is not None and self.taps != cfg.taps:
            cfg = dataclasses.replace(cfg, taps=self.taps)
        if self.backend is not None and self.backend != cfg.agg.backend:
            cfg = dataclasses.replace(
                cfg, agg=dataclasses.replace(cfg.agg, backend=self.backend))
        return cfg


def resolve_options(options: Optional[RoundOptions] = None, *,
                    engine: Optional[str] = None,
                    chunk: Optional[int] = None,
                    taps: Optional[bool] = None,
                    backend: Optional[str] = None,
                    checkpoint: Optional[Any] = None) -> RoundOptions:
    """Start from ``options`` (or the all-inherit default) and overlay any
    explicitly passed keywords."""
    base = options if options is not None else RoundOptions()
    return base.merged(engine=engine, chunk=chunk, taps=taps,
                       backend=backend, checkpoint=checkpoint)
