from repro_torch.kernels.bucketgram.ops import (
    REG_NB, assignment_matrix, bucket_means_gram, bucket_means_gram_lanes_ref,
    bucket_means_gram_ref, bucketgram, bucketgram_lanes, bucketmeans,
    bucketmeans_lanes,
)

__all__ = ["REG_NB", "assignment_matrix", "bucket_means_gram",
           "bucket_means_gram_lanes_ref", "bucket_means_gram_ref",
           "bucketgram", "bucketgram_lanes", "bucketmeans",
           "bucketmeans_lanes"]
