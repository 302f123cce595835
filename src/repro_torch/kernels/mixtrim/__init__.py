from repro_torch.kernels.mixtrim.ops import MAX_N, mixtrim, mixtrim_ref

__all__ = ["MAX_N", "mixtrim", "mixtrim_ref"]
