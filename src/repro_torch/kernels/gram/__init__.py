from repro_torch.kernels.gram.ops import (
    gram, gram_batched, gram_batched_ref, gram_ref,
)

__all__ = ["gram", "gram_batched", "gram_batched_ref", "gram_ref"]
