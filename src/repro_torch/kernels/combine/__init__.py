from repro_torch.kernels.combine.ops import combine, combine_ref

__all__ = ["combine", "combine_ref"]
