"""K3 · streamed coefficient combine r = c X of a (n, D) worker stack.

:func:`combine` is the wrapper: for a CUDA stack it launches the kernel of
``csrc/combine.cu`` (the counterpart of the TPU kernel
``repro/kernels/combine/kernel.py::combine_pallas``); for a CPU stack it
runs :func:`combine_ref`, the plain version.  ``combine.launches`` counts
kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._common import check_small, check_stack, stream_of

_THREADS = 256
_BLOCKS_PER_SM = 16


def combine_ref(x: torch.Tensor, coeff: torch.Tensor) -> torch.Tensor:
    """Plain version: coeff rounded to X's dtype, then fp32 products and
    sums (the ``tree_combine`` bf16-transport contract)."""
    return coeff.to(x.dtype).float() @ x.float()


def combine(x: torch.Tensor, coeff: torch.Tensor) -> torch.Tensor:
    """(n, D) fp32 / bf16 and (n,) fp32 -> (D,) fp32."""
    if x.device.type == "cpu":
        return combine_ref(x, coeff)
    check_stack(x, "combine")
    n, d = x.shape
    check_small(coeff, (n,), x, "combine coeff")
    lib = _build.library()
    units = -(-d // 4)
    blocks = max(1, min(-(-units // _THREADS),
                        _BLOCKS_PER_SM * _build.sm_count(x.device)))
    out = torch.empty((d,), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        rc = lib.repro_combine(x.data_ptr(), _build.dtype_code(x.dtype),
                               coeff.data_ptr(), n, d, out.data_ptr(), blocks,
                               stream_of(x))
    _build.check(rc, "combine kernel")
    combine.launches += 1
    return out


combine.launches = 0
