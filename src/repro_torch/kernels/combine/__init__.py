from repro_torch.kernels.combine.ops import (
    combine, combine_lanes, combine_lanes_ref, combine_ref,
)

__all__ = ["combine", "combine_lanes", "combine_lanes_ref", "combine_ref"]
