"""K3 · streamed coefficient combine r = c X of a (n, D) worker stack.

:func:`combine` is the wrapper: for a CUDA stack it launches the kernel of
``csrc/combine.cu`` (the counterpart of the TPU kernel
``repro/kernels/combine/kernel.py::combine_pallas``); for a CPU stack it
runs :func:`combine_ref`, the plain version.  ``combine.launches`` counts
kernel launches.

:func:`combine_lanes` is the lane form (``combine_pallas`` under the
reference's ``jax.vmap``: the fleet's gram-rule lanes, one launch a
bucket-round): (B, n, D) and (B, n) coefficients -> (B, D), lane b equal
to :func:`combine` on lane b bit for bit; :func:`combine_lanes_ref` is its
plain version, :func:`combine_ref` on each lane.  It counts its launches
in ``combine_lanes.launches``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._common import (
    check_lanes, check_small, check_stack, stream_of,
)

_THREADS = 256
_BLOCKS_PER_SM = 16


def combine_ref(x: torch.Tensor, coeff: torch.Tensor) -> torch.Tensor:
    """Plain version: coeff rounded to X's dtype, then fp32 products and
    sums (the ``tree_combine`` bf16-transport contract)."""
    return coeff.to(x.dtype).float() @ x.float()


def _launch(x: torch.Tensor, coeff: torch.Tensor) -> torch.Tensor:
    """K3 on a (L, n, D) stack with (L, n) coefficients -> (L, D) fp32; a
    single stack is lane 0 of L = 1.  One thread per four columns, at most
    ``_BLOCKS_PER_SM`` blocks an SM for each lane."""
    lanes, n, d = x.shape
    check_small(coeff, (lanes, n), x, "combine coeff")
    lib = _build.library()
    units = -(-d // 4)
    blocks = max(1, min(-(-units // _THREADS),
                        _BLOCKS_PER_SM * _build.sm_count(x.device)))
    out = torch.empty((lanes, d), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        rc = lib.repro_combine(x.data_ptr(), _build.dtype_code(x.dtype),
                               coeff.data_ptr(), lanes, n, d, out.data_ptr(),
                               blocks, stream_of(x))
    _build.check(rc, "combine kernel")
    return out


def combine(x: torch.Tensor, coeff: torch.Tensor) -> torch.Tensor:
    """(n, D) fp32 / bf16 and (n,) fp32 -> (D,) fp32."""
    if x.device.type == "cpu":
        return combine_ref(x, coeff)
    check_stack(x, "combine")
    out = _launch(x[None], coeff.reshape(1, -1))[0]
    combine.launches += 1
    return out


combine.launches = 0


def combine_lanes_ref(x: torch.Tensor, coeff: torch.Tensor) -> torch.Tensor:
    """Plain version of the lane form: :func:`combine_ref` on each lane."""
    return torch.stack([combine_ref(x[k], coeff[k])
                        for k in range(x.shape[0])])


def combine_lanes(x: torch.Tensor, coeff: torch.Tensor) -> torch.Tensor:
    """(B, n, D) fp32 / bf16 and (B, n) fp32 -> (B, D) fp32, every lane in
    one launch."""
    if x.device.type == "cpu":
        return combine_lanes_ref(x, coeff)
    check_lanes(x, "combine_lanes")
    out = _launch(x, coeff)
    combine_lanes.launches += 1
    return out


combine_lanes.launches = 0
