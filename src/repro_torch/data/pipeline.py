"""Worker-sharded batching: the distributed input pipeline.

Produces batches with a leading worker axis — the shape the robust trainer
consumes ((n_workers, per_worker_batch, ...), sharded over the mesh worker
axes on a pod).  Label flipping for the LF attack is applied here: the f
Byzantine workers compute *honest* gradients on labels (C-1) - l, exactly
the paper's protocol (Appendix 14.3).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np

from repro_torch.data.dirichlet import partition_by_class


@dataclasses.dataclass
class WorkerDataset:
    """Per-worker views into a shared array store."""
    arrays: dict[str, np.ndarray]          # full dataset, e.g. {"x": ..., "y": ...}
    worker_idx: list[np.ndarray]           # index list per worker

    @property
    def n_workers(self) -> int:
        return len(self.worker_idx)


def build_heterogeneous(arrays: dict[str, np.ndarray], labels_key: str,
                        n_workers: int, alpha: float, seed: int = 0
                        ) -> WorkerDataset:
    idx = partition_by_class(arrays[labels_key], n_workers, alpha, seed)
    return WorkerDataset(arrays, idx)


def infer_n_classes(ds: WorkerDataset, labels_key: str = "y"
                    ) -> Optional[int]:
    if labels_key not in ds.arrays:
        return None
    return int(ds.arrays[labels_key].max()) + 1


def sample_worker_batch(ds: WorkerDataset, worker: int, size: int,
                        rng: np.random.Generator, *, flip: bool = False,
                        labels_key: str = "y",
                        n_classes: Optional[int] = None
                        ) -> dict[str, np.ndarray]:
    """One worker's {key: (size, ...)} sample, with-replacement.

    ``flip`` applies the LF attack's label transformation l -> C-1-l — the
    Byzantine worker computes honestly on corrupted labels.  This is THE
    sampling + flip primitive; both the lockstep pipeline and the federated
    cohort batcher go through it so the semantics cannot drift.
    """
    take = rng.choice(ds.worker_idx[worker], size=size, replace=True)
    out = {}
    for k, arr in ds.arrays.items():
        part = arr[take]
        if flip and k == labels_key and n_classes is not None:
            part = (n_classes - 1) - part
        out[k] = part
    return out


def worker_batches(ds: WorkerDataset, batch_size: int, *, seed: int = 0,
                   flip_labels_for: int = 0, labels_key: str = "y",
                   n_classes: Optional[int] = None
                   ) -> Iterator[dict[str, np.ndarray]]:
    """Infinite iterator of {key: (n_workers, batch, ...)} batches.

    ``flip_labels_for`` = f: the LAST f workers receive flipped labels
    (l -> C-1-l), implementing the LF attack through honest computation.
    """
    rng = np.random.default_rng(seed)
    n = ds.n_workers
    if n_classes is None:
        n_classes = infer_n_classes(ds, labels_key)
    while True:
        rows = [sample_worker_batch(ds, w, batch_size, rng,
                                    flip=w >= n - flip_labels_for,
                                    labels_key=labels_key,
                                    n_classes=n_classes)
                for w in range(n)]
        yield {k: np.stack([r[k] for r in rows]) for k in ds.arrays}


def full_batches(ds: WorkerDataset, *, flip_labels_for: int = 0,
                 labels_key: str = "y", n_classes: Optional[int] = None
                 ) -> dict[str, np.ndarray]:
    """Full per-worker datasets stacked (for D-GD's exact gradients).

    Requires equal per-worker sizes (guaranteed by partition_by_class)."""
    n = ds.n_workers
    if n_classes is None and labels_key in ds.arrays:
        n_classes = int(ds.arrays[labels_key].max()) + 1
    out = {}
    for k, arr in ds.arrays.items():
        parts = []
        for w in range(n):
            part = arr[ds.worker_idx[w]]
            if (k == labels_key and w >= n - flip_labels_for
                    and n_classes is not None):
                part = (n_classes - 1) - part
            parts.append(part)
        out[k] = np.stack(parts)
    return out
