from repro_torch.kernels.bucketgram.ops import (
    REG_NB, assignment_matrix, bucket_means_gram, bucket_means_gram_ref,
    bucketgram, bucketmeans,
)

__all__ = ["REG_NB", "assignment_matrix", "bucket_means_gram",
           "bucket_means_gram_ref", "bucketgram", "bucketmeans"]
