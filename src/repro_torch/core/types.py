"""Shared types for the Byzantine-robust aggregation core.

The canonical input of every aggregation primitive is a 2-D stack
``x : (n, d)`` holding one vector per worker; pytree-level wrappers live
in :mod:`repro_torch.core.robust`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

#: Backends of the port.  "torch" is the leaf-streamed plain path (the
#: reference's "xla"); "cuda" flattens the worker stack to one (n, D)
#: buffer and runs the hand-written gram / combine / mixtrim kernels (the
#: reference's "pallas"); "cuda_sharded" runs them on each rank's column
#: block of a multi-rank mesh (the reference's "pallas_sharded"), and
#: "cuda_hier" adds the hierarchical stage, its stack split along workers
#: and columns on a 2-D mesh (the reference's "pallas_hier"); "auto" picks
#: the sharded form on CUDA under a multi-rank mesh, "cuda" for a CUDA
#: stack and "torch" otherwise.
BACKENDS = ("torch", "cuda", "cuda_sharded", "cuda_hier", "auto")


@dataclasses.dataclass(frozen=True)
class AggregatorSpec:
    """Fully describes a robust aggregation pipeline.

    Attributes mirror ``repro.core.types.AggregatorSpec``.  ``hier``
    inserts the single-device hierarchical bucketing stage (bucket size
    ``bucket_size``, default floor(n/2f)); ``pre`` is None, "nnm" or
    "bucketing".  ``sketch_dim`` > 0 takes the Gram of a signed
    (n, sketch_dim) sketch when randomness is given.  ``backend`` is one
    of :data:`BACKENDS`; "cuda_hier" implies the hierarchical stage.
    """

    rule: str = "cwtm"
    f: int = 0
    pre: Optional[str] = "nnm"
    bucket_size: Optional[int] = None
    hier: bool = False
    gm_iters: int = 8
    gm_eps: float = 1e-8
    autogm_lamb: float = 1.0
    autogm_iters: int = 4
    backend: str = "auto"
    transport_dtype: Optional[str] = None          # None (=fp32) | "bf16"
    sketch_dim: int = 0

    def describe(self) -> str:
        pre = f"{self.pre}+" if self.pre else ""
        return f"{pre}{self.rule}(f={self.f})"


#: Rules whose output is a linear combination coeff @ x with coeff a pure
#: function of the Gram matrix.
GRAM_RULES = frozenset({"average", "krum", "multikrum", "gm", "autogm",
                        "mda"})

#: Rules that operate coordinate-wise on the (optionally mixed) stack.
COORDINATE_RULES = frozenset({"cwmed", "cwtm", "meamed"})

ALL_RULES = tuple(sorted(GRAM_RULES | COORDINATE_RULES))

#: Attack names, the reference's: the ``_opt`` eta searches run on the
#: static paths (the trainer, the fed server), not on fleet lanes.
ATTACKS = ("none", "alie", "foe", "sf", "lf", "mimic", "alie_opt", "foe_opt",
           "nan", "inf")
