"""Numpy-only data modules, kept as the port's own copy of ``repro.data``:
they replay the same numpy calls, so shards and batches are identical to
the reference's for the same seed."""
from repro_torch.data.dirichlet import dirichlet_proportions, heterogeneity_g2, partition_by_class
from repro_torch.data.pipeline import (
    WorkerDataset, build_heterogeneous, full_batches, worker_batches,
)
from repro_torch.data.synthetic import make_classification, make_lm_corpus

__all__ = [
    "dirichlet_proportions", "heterogeneity_g2", "partition_by_class",
    "WorkerDataset", "build_heterogeneous", "full_batches", "worker_batches",
    "make_classification", "make_lm_corpus",
]
