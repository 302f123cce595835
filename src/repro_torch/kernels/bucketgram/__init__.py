from repro_torch.kernels.bucketgram.ops import (
    MEANS_NB, REG_NB, assignment_matrix, bucket_means_gram,
    bucket_means_gram_lanes_ref, bucket_means_gram_ref, bucketgram,
    bucketgram_lanes, bucketgram_lanes_perms, bucketmeans, bucketmeans_lanes,
    bucketmeans_lanes_perms, perm_assignment, perm_plan_ref, plan_arrays,
)

__all__ = ["MEANS_NB", "REG_NB", "assignment_matrix", "bucket_means_gram",
           "bucket_means_gram_lanes_ref", "bucket_means_gram_ref",
           "bucketgram", "bucketgram_lanes", "bucketgram_lanes_perms",
           "bucketmeans", "bucketmeans_lanes", "bucketmeans_lanes_perms",
           "perm_assignment", "perm_plan_ref", "plan_arrays"]
