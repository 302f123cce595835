"""Durable chunk-boundary snapshot store: async, double-buffered, atomic
(counterpart of ``repro.resilience.store``; the same on-disk layout).

Layout of a checkpoint directory::

    <dir>/
      snapshot-00000025.npz   # flat name -> array payload for round 25
      snapshot-00000050.npz
      MANIFEST.json           # {"format": 1, "latest": {...}, "history": [...]}

Each ``save()`` enqueues one snapshot on a single background writer
thread and returns; at most two writes are in flight (double-buffered),
so the next segment runs while the previous snapshot is written, and a
slow disk back-pressures instead of queueing without bound.

Consistency: the port's carries are written IN PLACE by the next segment
(the trainer's and the fed server's flat momentum), so a writer that read
the caller's tensors later would store a mix of two rounds.  ``save()``
therefore clones every tensor before it returns, on the caller's thread
and, for a CUDA tensor, on the caller's current stream, and records one
CUDA event after the clones.  The writer waits on that event, then copies
the clones to the host on a stream of its own (so the copy does not queue
behind the next segment's work) and frees each clone once copied.  The
cost is one device copy of the snapshot per write in flight; the
synchronous paths (``sync=True``, the fault drills) copy nothing.

Durability per snapshot: write ``*.tmp`` -> fsync -> atomic rename ->
directory fsync, then the manifest by the same sequence.  A kill at any
point leaves the previous manifest (and the complete snapshot it points
to) intact: restore always finds the last *complete* snapshot.

Values passed to ``save()`` may be tensors (bf16 ones stored as their
``uint16`` bits, the kind recorded in the manifest entry's ``dtypes``),
numpy arrays, Python numbers (kind recorded too), or a *list* of those
to concatenate along axis 0 (metric columns accumulated per segment).
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import os
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.checkpoint.npz import encode_leaf, fsync_replace
from repro_torch.obs import runtime as obs_runtime

from .faults import CheckpointError, FaultPlan, SimulatedPreemption

_FORMAT = 1
MANIFEST = "MANIFEST.json"


@dataclasses.dataclass(frozen=True)
class CheckpointConfig:
    """Rides on ``RoundOptions.checkpoint`` to make a run resumable.

    ``dir``        checkpoint directory (created on the first snapshot).
    ``every``      snapshot every Nth segment boundary (1 = all; the final
                   boundary always).
    ``keep``       retain this many newest snapshot files.
    ``sync``       write in the caller's thread (tests).
    ``resume``     load the latest manifest before running (False forces a
                   fresh run into an existing directory).
    ``fault_plan`` optional :class:`FaultPlan` for kill / torn-write drills.
    """

    dir: str
    every: int = 1
    keep: int = 2
    sync: bool = False
    resume: bool = True
    fault_plan: Optional[FaultPlan] = None


def _snapshot_name(round_: int) -> str:
    return f"snapshot-{round_:08d}.npz"


def _freeze(arrays: dict) -> tuple[dict, list]:
    """Clones of every tensor value (list elements too) and one
    ``(device, CUDA event)`` per device, the event recorded on the
    device's current stream after the clones."""
    devices: dict = {}

    def clone(v):
        if isinstance(v, torch.Tensor):
            v = v.detach().clone()
            if v.is_cuda:
                devices[v.device] = None
        return v

    frozen = {name: [clone(v) for v in value]
              if isinstance(value, (list, tuple)) else clone(value)
              for name, value in arrays.items()}
    events = []
    for dev in devices:
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(dev))
        events.append((dev, ev))
    return frozen, events


class SnapshotStore:
    """One checkpoint directory: async writer + manifest + restore."""

    def __init__(self, path: str, *, keep: int = 2, sync: bool = False,
                 fault_plan: Optional[FaultPlan] = None):
        self.path = path
        self.keep = max(1, keep)
        self.sync = sync
        self.fault_plan = fault_plan
        self.snapshots_written = 0
        self._ordinal = 0          # save() calls in this process (fault clock)
        self._history: list[dict] = []
        self._pool: Optional[ThreadPoolExecutor] = None
        self._inflight: collections.deque[Future] = collections.deque()
        self._streams: dict = {}   # device -> the writer's copy stream

    @classmethod
    def from_config(cls, cfg: CheckpointConfig,
                    subdir: Optional[str] = None) -> "SnapshotStore":
        path = os.path.join(cfg.dir, subdir) if subdir else cfg.dir
        return cls(path, keep=cfg.keep, sync=cfg.sync,
                   fault_plan=cfg.fault_plan)

    # -- write path -------------------------------------------------------

    def save(self, round_: int, arrays: dict[str, Any], meta: dict) -> None:
        """Write one snapshot: enqueued (blocks only while two writes are
        in flight) unless ``sync`` or a fault drill fires."""
        ordinal = self._ordinal
        self._ordinal += 1
        plan = self.fault_plan
        if plan is not None and plan.torn_at == ordinal:
            self.wait()
            self._write_torn(round_, dict(arrays))
            raise SimulatedPreemption(ordinal, round_)
        if plan is not None and plan.kill_at == ordinal:
            self.wait()
            self._write(round_, dict(arrays), meta)
            raise SimulatedPreemption(ordinal, round_)
        if self.sync:
            self._write(round_, dict(arrays), meta)
            return
        if self._pool is None:
            self._pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="snapshot")
        while len(self._inflight) >= 2:       # double-buffer back-pressure
            self._inflight.popleft().result()
        frozen, events = _freeze(arrays)      # at most two copies alive
        self._inflight.append(
            self._pool.submit(self._write, round_, frozen, meta, events))

    def wait(self) -> None:
        """Drain pending writes, re-raising any writer-thread error."""
        while self._inflight:
            self._inflight.popleft().result()

    def close(self) -> None:
        self.wait()
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None

    def _copy_streams(self, events: list) -> contextlib.ExitStack:
        """Wait for the clones, then make each device's current stream the
        writer's own copy stream (for the ``with`` block)."""
        stack = contextlib.ExitStack()
        for dev, ev in events:
            ev.synchronize()
            if dev not in self._streams:
                self._streams[dev] = torch.cuda.Stream(device=dev)
            stack.enter_context(torch.cuda.stream(self._streams[dev]))
        return stack

    @staticmethod
    def _host_arrays(arrays: dict) -> tuple[dict, dict]:
        """Values -> numpy, popping each from ``arrays`` once converted (a
        clone's device memory is freed at once).  Lists concatenate along
        axis 0."""
        out, kinds = {}, {}
        for name in list(arrays):
            value = arrays.pop(name)
            if isinstance(value, (list, tuple)):
                out[name] = np.concatenate(
                    [encode_leaf(v)[0] for v in value], axis=0)
            else:
                out[name], kind = encode_leaf(value)
                if kind is not None:
                    kinds[name] = kind
            del value
        return out, kinds

    def _write(self, round_: int, arrays: dict, meta: dict,
               events: tuple = ()) -> None:
        with obs_runtime.span("resilience.snapshot", path=self.path,
                              round=round_) as ev:
            with self._copy_streams(events):
                host, kinds = self._host_arrays(arrays)
            meta = dict(meta)
            if kinds:
                meta["dtypes"] = kinds
            os.makedirs(self.path, exist_ok=True)
            fname = _snapshot_name(round_)
            fpath = os.path.join(self.path, fname)
            with open(fpath + ".tmp", "wb") as fh:
                np.savez(fh, **host)
                fh.flush()
                os.fsync(fh.fileno())
                size = fh.tell()
            del host
            fsync_replace(fpath + ".tmp", fpath)
            self._update_manifest({"file": fname, "round": int(round_),
                                   "meta": meta})
            self._prune()
            ev["args"]["bytes"] = size
            self.snapshots_written += 1

    def _write_torn(self, round_: int, arrays: dict) -> None:
        """Half-written snapshot file, manifest untouched: a kill between
        the data write and the manifest update."""
        host, _ = self._host_arrays(arrays)
        os.makedirs(self.path, exist_ok=True)
        fpath = os.path.join(self.path, _snapshot_name(round_))
        with open(fpath, "wb") as fh:
            np.savez(fh, **host)
            fh.truncate(max(1, fh.tell() // 2))
        obs_runtime.event("resilience.torn_write", path=fpath, round=round_)

    def _update_manifest(self, entry: dict) -> None:
        self._history.append(entry)
        self._history = self._history[-self.keep:]
        manifest = {"format": _FORMAT, "latest": entry,
                    "history": self._history}
        mpath = os.path.join(self.path, MANIFEST)
        with open(mpath + ".tmp", "w") as fh:
            json.dump(manifest, fh)
            fh.flush()
            os.fsync(fh.fileno())
        fsync_replace(mpath + ".tmp", mpath)

    def _prune(self) -> None:
        live = {e["file"] for e in self._history}
        for fname in os.listdir(self.path):
            if (fname.startswith("snapshot-") and fname.endswith(".npz")
                    and fname not in live):
                try:
                    os.unlink(os.path.join(self.path, fname))
                except OSError:
                    pass

    # -- read path --------------------------------------------------------

    def _on_disk(self) -> list[str]:
        if not os.path.isdir(self.path):
            return []
        return sorted(f for f in os.listdir(self.path)
                      if f.startswith("snapshot-") and f.endswith(".npz"))

    def load_manifest(self) -> Optional[dict]:
        mpath = os.path.join(self.path, MANIFEST)
        if not os.path.exists(mpath):
            return None
        try:
            with open(mpath) as fh:
                manifest = json.load(fh)
            latest = manifest["latest"]
            _ = latest["file"], latest["round"]
        except (json.JSONDecodeError, KeyError, TypeError) as exc:
            raise CheckpointError(
                f"checkpoint manifest {mpath!r} is corrupt ({exc!r})",
                hint=("snapshot files on disk: "
                      f"{self._on_disk() or 'none'}; delete MANIFEST.json to "
                      "start fresh, or restore it to point at one of these"),
            ) from exc
        return manifest

    def load_latest(self) -> Optional[tuple[int, dict, dict]]:
        """``(round, arrays, meta)`` of the newest complete snapshot,
        ``None`` if the directory has no manifest; raises
        :class:`CheckpointError` (with a recovery hint) if the manifest is
        corrupt or points at an unreadable file."""
        manifest = self.load_manifest()
        if manifest is None:
            return None
        latest = manifest["latest"]
        fpath = os.path.join(self.path, latest["file"])
        try:
            # np.load leaks its own file handle when the zip is torn.
            with obs_runtime.span("resilience.load", path=self.path,
                                  round=latest["round"]), \
                    open(fpath, "rb") as fh, np.load(fh) as data:
                arrays = {k: data[k] for k in data.files}
        except Exception as exc:
            older = [e["file"] for e in manifest.get("history", [])
                     if e["file"] != latest["file"]]
            raise CheckpointError(
                f"latest snapshot {fpath!r} is unreadable ({exc!r})",
                hint=(f"older snapshots in the manifest history: {older}; "
                      "edit MANIFEST.json's `latest` to one of these, or "
                      "delete MANIFEST.json to start fresh"
                      if older else
                      "no older snapshots remain; delete MANIFEST.json to "
                      "start fresh"),
            ) from exc
        # Seed retention / history from disk so a resumed store keeps pruning.
        self._history = list(manifest.get("history", []))[-self.keep:]
        obs_runtime.event("resilience.resume", path=self.path,
                          round=latest["round"])
        return int(latest["round"]), arrays, dict(latest["meta"])
