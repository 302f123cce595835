from repro_torch.kernels.gram.ops import gram, gram_ref

__all__ = ["gram", "gram_ref"]
