"""Owner-facing helpers: carry + metrics + cursor snapshots at segment
boundaries (counterpart of ``repro.resilience.experiment``).

The three loop owners (``train_loop``, ``fed.run_rounds``, ``FleetRunner``)
share one resume shape:

- the **host plan** (batches, cohorts, round seeds, attack operands) is
  recomputed deterministically from the seed, so it is never stored; only
  the ``round`` cursor is;
- the **carry** is stored as flat ``carry/NNN`` entries in the port's leaf
  order (:func:`repro_torch.tree.tree_leaves`) against a caller-known
  ``like`` structure (no structure is serialised);
- the **metrics so far** are stored as concatenated ``metrics/<col>``
  columns, so a resumed run returns histories bit-identical to an
  uninterrupted one;
- an owner-specific JSON ``payload`` carries host-side history (eval
  points, best accuracy) that already fired before the kill.

A ``signature`` (plan fingerprint: surface, rounds, chunk, seed, ...) is
stored with every snapshot and checked on resume: resuming a different
experiment into the same directory is a clean refusal, not silent garbage.
"""
from __future__ import annotations

import json
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.checkpoint.npz import decode_leaf
from repro_torch.tree import tree_leaves, tree_structure, tree_unflatten

from .faults import CheckpointError
from .store import CheckpointConfig, SnapshotStore

_CARRY = "carry/"
_METRIC = "metrics/"


def resolve_checkpoint(checkpoint: Any) -> Optional[CheckpointConfig]:
    """Accept a :class:`CheckpointConfig` or a bare directory path."""
    if checkpoint is None:
        return None
    if isinstance(checkpoint, CheckpointConfig):
        return checkpoint
    if isinstance(checkpoint, str):
        return CheckpointConfig(dir=checkpoint)
    raise TypeError(
        f"checkpoint= must be a CheckpointConfig or path, got {checkpoint!r}")


def normalize_signature(sig: dict) -> dict:
    """JSON round trip so tuples / numpy ints compare equal after reload."""
    return json.loads(json.dumps(sig, sort_keys=True, default=str))


#: The refusal's hint when the tap columns differ from the snapshot's.
_TAPS_HINT = ("taps/metrics configuration changed between runs; use a "
              "fresh checkpoint dir")


def check_signature(saved: dict, current: dict, path: str) -> None:
    """Refuse a snapshot written by another plan; a tapped run's
    signature carries ``"taps": True``, so a run with other tap columns
    than the snapshot's is refused here, before any round runs."""
    saved_n, cur_n = normalize_signature(saved), normalize_signature(current)
    if saved_n != cur_n:
        diff = {k: (saved_n.get(k), cur_n.get(k))
                for k in sorted(set(saved_n) | set(cur_n))
                if saved_n.get(k) != cur_n.get(k)}
        raise CheckpointError(
            f"snapshot in {path!r} belongs to a different experiment plan; "
            f"mismatched fields (saved, current): {diff}",
            hint=_TAPS_HINT if "taps" in diff else
            "point checkpoint.dir at a fresh directory, or pass a config "
            "matching the saved plan",
        )


def _expand(metrics: dict) -> dict[str, Any]:
    """A metrics dict with every ``to_dict``-able value (a
    :class:`~repro_torch.obs.HealthTaps`) expanded to ``<key>.<field>``."""
    out: dict[str, Any] = {}
    for key, value in metrics.items():
        if hasattr(value, "to_dict"):
            for field, arr in value.to_dict().items():
                out[f"{key}.{field}"] = arr
        else:
            out[key] = value
    return out


def metric_columns(metrics: Any) -> dict[str, Any]:
    """Named metric columns with the rounds on axis 0, with no device
    sync: a dict of columns passes through; a list of per-round dicts
    (what :class:`~repro_torch.rounds.RoundEngine` hands ``on_segment``)
    is stacked, tensors on their device, Python numbers into numpy.
    ``to_dict``-able values expand to ``<key>.<field>`` columns."""
    if isinstance(metrics, dict):
        return _expand(metrics)
    metrics = [_expand(m) for m in metrics]
    out: dict[str, Any] = {}
    for key in metrics[0]:
        vals = [m[key] for m in metrics]
        out[key] = torch.stack(vals) if isinstance(vals[0], torch.Tensor) \
            else np.asarray(vals)
    return out


def restore_carry(arrays: dict, meta: dict, like: Any) -> Any:
    """Rebuild the carry from flat ``carry/NNN`` entries, taking structure,
    devices, dtypes and Python number types from ``like``."""
    leaves = tree_leaves(like)
    kinds = meta.get("dtypes", {})
    out = []
    for i, leaf in enumerate(leaves):
        name = f"{_CARRY}{i:03d}"
        if name not in arrays:
            raise CheckpointError(
                f"snapshot is missing carry leaf {name!r} "
                f"(has {len(leaves)} leaves in the current plan)",
                hint="the snapshot was written by an incompatible model/"
                     "optimizer configuration; use a fresh checkpoint dir",
            )
        try:
            out.append(decode_leaf(arrays[name], leaf, kinds.get(name)))
        except ValueError as exc:
            raise CheckpointError(
                f"carry leaf {name!r} does not fit the current plan ({exc})",
                hint="the snapshot was written by an incompatible model/"
                     "optimizer configuration; use a fresh checkpoint dir",
            ) from exc
    return tree_unflatten(tree_structure(like), out)


def restored_metrics(arrays: dict) -> dict[str, np.ndarray]:
    return {k[len(_METRIC):]: np.asarray(v) for k, v in arrays.items()
            if k.startswith(_METRIC)}


def concat_metrics(saved: dict[str, np.ndarray],
                   new: dict[str, Any]) -> dict[str, np.ndarray]:
    """Stitch restored columns onto this process's columns (rounds axis 0)."""
    if not saved:
        return {k: np.asarray(v) for k, v in new.items()}
    out = {}
    for key in new:
        if key not in saved:
            raise CheckpointError(
                f"restored metrics are missing column {key!r}",
                hint=_TAPS_HINT)
        out[key] = np.concatenate([saved[key], np.asarray(new[key])], axis=0)
    return out


class CarryCheckpointer:
    """Accumulates per-segment metrics and snapshots carry + metrics so
    far + cursor at segment boundaries.

    Wire :meth:`on_segment` into ``RoundEngine.run(on_segment=...)``.
    Device values go to the store as they are; the store takes its own
    consistent copies before ``save`` returns and converts them to host
    arrays in its writer thread, so the next segment runs while the
    snapshot is written.
    """

    def __init__(self, store: SnapshotStore, *, signature: dict,
                 total: int, every: int = 1,
                 base_columns: Optional[dict] = None,
                 payload_fn: Optional[Callable[[int], dict]] = None):
        self.store = store
        self.signature = normalize_signature(signature)
        self.total = total
        self.every = max(1, every)
        self._base = dict(base_columns or {})
        self._cols: dict[str, list] = {}   # per-column segments
        self._boundaries = 0
        self._payload_fn = payload_fn

    def on_segment(self, start: int, end: int, state: Any,
                   metrics: Any) -> None:
        del start
        for key, value in metric_columns(metrics).items():
            self._cols.setdefault(key, []).append(value)
        self._boundaries += 1
        if (self._boundaries % self.every) and end != self.total:
            return
        arrays: dict[str, Any] = {f"{_CARRY}{i:03d}": leaf for i, leaf
                                  in enumerate(tree_leaves(state))}
        for key, segs in self._cols.items():
            base = [self._base[key]] if key in self._base else []
            arrays[f"{_METRIC}{key}"] = base + list(segs)
        meta = {"signature": self.signature,
                "payload": self._payload_fn(end) if self._payload_fn else {}}
        self.store.save(end, arrays, meta)

    def close(self) -> None:
        self.store.close()
