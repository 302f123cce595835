"""Stand-ins and specs for every model input (counterpart of
``repro.launch.specs``).

``train_input_specs`` / ``prefill_input_specs`` / ``decode_input_specs``
return (a dict of ``meta`` tensors, a dict of spec tuples) for an input
shape: the tensors carry the shapes and dtypes and allocate nothing, the
spec tuples are the reference's ``PartitionSpec`` entries (a one-axis
tuple written as the axis name, as ``MeshAxes.logical_to_spec`` writes
it).  ``launch.dryrun`` runs against them; ``materialize_batch`` makes a
real numpy batch of the same shapes with the reference's numpy calls, in
its order, so both packages draw the same numbers.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import InputShape, ModelConfig

PyTree = Any


def _data_entry(axes) -> Any:
    """``P(axes.data)``'s one entry: the axis name, or the tuple of them."""
    return axes.data[0] if len(axes.data) == 1 else tuple(axes.data)


def _meta(shape: tuple, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _train_batch_shapes(cfg: ModelConfig, shape: InputShape, n_workers: int
                        ) -> dict[str, tuple[tuple[int, ...], torch.dtype]]:
    """{name: (shape, dtype)} with a leading worker axis."""
    assert shape.global_batch % n_workers == 0, (shape.global_batch, n_workers)
    pw = shape.global_batch // n_workers
    seq = shape.seq_len
    out: dict = {}
    if cfg.family == "vlm":
        text = seq - cfg.num_patches
        out["tokens"] = ((n_workers, pw, text), torch.int32)
        out["labels"] = ((n_workers, pw, text), torch.int32)
        out["patches"] = ((n_workers, pw, cfg.num_patches, cfg.vision_dim),
                          torch.bfloat16)
    elif cfg.family == "encdec":
        out["tokens"] = ((n_workers, pw, seq), torch.int32)
        out["labels"] = ((n_workers, pw, seq), torch.int32)
        out["frames"] = ((n_workers, pw, cfg.encoder_seq, cfg.d_model),
                         torch.bfloat16)
    else:
        out["tokens"] = ((n_workers, pw, seq), torch.int32)
        out["labels"] = ((n_workers, pw, seq), torch.int32)
    return out


def train_input_specs(cfg: ModelConfig, shape: InputShape, axes,
                      n_workers: int) -> tuple[PyTree, PyTree]:
    """The trainer's batch: every leaf (n_workers, per-worker rows, ...),
    the worker axis over the data axes."""
    shapes = _train_batch_shapes(cfg, shape, n_workers)
    meta = {k: _meta(s, d) for k, (s, d) in shapes.items()}
    return meta, {k: (_data_entry(axes),) for k in shapes}


def prefill_input_specs(cfg: ModelConfig, shape: InputShape, axes
                        ) -> tuple[PyTree, PyTree]:
    """A forward's batch: rows over the data axes when there are several."""
    b, seq = shape.global_batch, shape.seq_len
    spec = (_data_entry(axes) if b > 1 else None,)
    if cfg.family == "vlm":
        text = seq - cfg.num_patches
        out = {"tokens": _meta((b, text), torch.int32),
               "patches": _meta((b, cfg.num_patches, cfg.vision_dim),
                                torch.bfloat16)}
    elif cfg.family == "encdec":
        out = {"tokens": _meta((b, seq), torch.int32),
               "frames": _meta((b, cfg.encoder_seq, cfg.d_model),
                               torch.bfloat16)}
    else:
        out = {"tokens": _meta((b, seq), torch.int32)}
    return out, {k: spec for k in out}


def decode_input_specs(cfg: ModelConfig, shape: InputShape, axes
                       ) -> tuple[PyTree, PyTree]:
    """(tokens, pos) of one decode step; the cache comes from
    ``cache_descs``."""
    b = shape.global_batch
    meta = {"tokens": _meta((b, 1), torch.int32),
            "pos": _meta((), torch.int32)}
    return meta, {"tokens": (_data_entry(axes) if b > 1 else None,),
                  "pos": ()}


def materialize_batch(cfg: ModelConfig, shapes: dict, seed: int = 0) -> dict:
    """A real numpy batch of ``shapes`` (a dict of tensors, e.g. the meta
    tensors of :func:`train_input_specs`): integer leaves uniform over the
    vocabulary as int32, the rest standard normal as float32, drawn from
    ``numpy.random.default_rng(seed)`` leaf by leaf in the dict's order,
    the reference's draws bit for bit."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in shapes.items():
        if v.dtype == torch.int32:
            out[k] = rng.integers(0, cfg.vocab_size,
                                  size=tuple(v.shape)).astype(np.int32)
        else:
            out[k] = rng.normal(size=tuple(v.shape)).astype(np.float32)
    return out
