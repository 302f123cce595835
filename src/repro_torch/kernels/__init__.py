"""Hand-written CUDA kernels of the robust-aggregation hot path.

Each kernel subpackage holds one ``ops.py`` with the wrapper (which
launches the kernel of ``csrc/*.cu`` for a CUDA stack, or runs the plain
version for a CPU stack), the plain version, and a launch counter.
Production code enters through :mod:`repro_torch.kernels.dispatch`.
Importing this package builds and loads nothing; ``_build.library()``
compiles on first use.
"""
from repro_torch.kernels.bucketgram import (
    bucket_means_gram, bucket_means_gram_lanes_ref, bucket_means_gram_ref,
    bucketgram, bucketgram_lanes, bucketgram_lanes_perms, bucketmeans,
    bucketmeans_lanes, bucketmeans_lanes_perms,
)
from repro_torch.kernels.combine import (
    combine, combine_lanes, combine_lanes_ref, combine_ref,
)
from repro_torch.kernels.gram import (
    gram, gram_batched, gram_batched_ref, gram_ref,
)
from repro_torch.kernels.mixtrim import (
    mixtrim, mixtrim_dyn, mixtrim_dyn_ref, mixtrim_lanes, mixtrim_lanes_ref,
    mixtrim_ref,
)

__all__ = ["bucket_means_gram", "bucket_means_gram_lanes_ref",
           "bucket_means_gram_ref", "bucketgram", "bucketgram_lanes",
           "bucketgram_lanes_perms", "bucketmeans", "bucketmeans_lanes",
           "bucketmeans_lanes_perms", "combine", "combine_lanes",
           "combine_lanes_ref", "combine_ref", "gram", "gram_batched",
           "gram_batched_ref", "gram_ref", "mixtrim", "mixtrim_dyn",
           "mixtrim_dyn_ref", "mixtrim_lanes", "mixtrim_lanes_ref",
           "mixtrim_ref"]
