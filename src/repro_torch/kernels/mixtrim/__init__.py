from repro_torch.kernels.mixtrim.ops import (
    MAX_N, mixtrim, mixtrim_dyn, mixtrim_dyn_ref, mixtrim_lanes,
    mixtrim_lanes_ref, mixtrim_ref,
)

__all__ = ["MAX_N", "mixtrim", "mixtrim_dyn", "mixtrim_dyn_ref",
           "mixtrim_lanes", "mixtrim_lanes_ref", "mixtrim_ref"]
