"""K2 · fused NNM mix + coordinate-wise trimmed mean / median (static f).

:func:`mixtrim` is the wrapper: for a CUDA stack it launches the kernel of
``csrc/mixtrim.cu`` (the counterpart of the TPU kernel
``repro/kernels/mixtrim/kernel.py::mixtrim_pallas``); for a CPU stack it
runs :func:`mixtrim_ref`, the plain version, which defines the semantics:
values sort with every NaN last (``torch.sort`` / ``jnp.sort`` order), so a
trim over the nan / inf attack stacks keeps the same ranks in both.
Up to 64 workers a register network sorts each column; above that (to
:data:`MAX_N`) a shared-memory network sorts tiles of columns.
``mixtrim.launches`` counts kernel launches.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._common import check_small, check_stack, stream_of

_THREADS = 256
_BLOCKS_PER_SM = 16
#: Largest worker count the register-network kernel takes
#: (csrc/mixtrim.cu SMALL_N); above it a shared-memory kernel sorts.
SMALL_N = 64
#: Largest worker count the kernels take (csrc/mixtrim.cu MAX_N): the next
#: power of two above the reference's largest scale n, 10240.
MAX_N = 16384


def mixtrim_ref(x: torch.Tensor, m: Optional[torch.Tensor], f: int,
                mode: str = "trim") -> torch.Tensor:
    """Plain version: Y = M @ X in fp32 (X alone when ``m`` is None), then
    the mean of sorted ranks [f, n-f) (the mean of Y when f == 0) or the
    median; (D,) fp32."""
    n = x.shape[0]
    y = x.float() if m is None else m.float() @ x.float()
    if mode == "trim":
        if f == 0:
            return y.mean(dim=0)
        return torch.sort(y, dim=0).values[f: n - f].mean(dim=0)
    if mode == "med":
        ys = torch.sort(y, dim=0).values
        if n % 2 == 1:
            return ys[n // 2]
        return 0.5 * (ys[n // 2 - 1] + ys[n // 2])
    raise ValueError(mode)


def mixtrim(x: torch.Tensor, m: Optional[torch.Tensor], f: int,
            mode: str = "trim") -> torch.Tensor:
    """(n, D) fp32 / bf16, optional (n, n) mixing matrix -> (D,) fp32.

    ``m`` arrives in X's dtype (the caller's bf16-transport rounding) or
    fp32; the kernel reads its fp32 values."""
    if mode not in ("trim", "med"):
        raise ValueError(f"mode must be 'trim' or 'med', got {mode!r}")
    n = x.shape[0]
    if mode == "trim" and not 0 <= f < n / 2:
        raise ValueError(f"need 0 <= f < n/2, got f={f}, n={n}")
    if x.device.type == "cpu":
        return mixtrim_ref(x, m, f, mode)
    check_stack(x, "mixtrim")
    if n > MAX_N:
        raise ValueError(f"mixtrim kernel takes n <= {MAX_N} workers, got "
                         f"n={n} (the port's one limit, ROADMAP queue 3)")
    d = x.shape[1]
    mf = None
    if m is not None:
        mf = m.float().contiguous()
        check_small(mf, (n, n), x, "mixtrim m")
    lib = _build.library()
    cap = _BLOCKS_PER_SM * _build.sm_count(x.device)
    # n > SMALL_N: the kernel takes tiles of columns and caps the grid at
    # its tile count itself.
    blocks = cap if n > SMALL_N else max(1, min(-(-d // _THREADS), cap))
    out = torch.empty((d,), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        rc = lib.repro_mixtrim(x.data_ptr(), _build.dtype_code(x.dtype),
                               None if mf is None else mf.data_ptr(), n, d,
                               int(f), int(mode == "med"), out.data_ptr(),
                               blocks, stream_of(x))
    _build.check(rc, "mixtrim kernel")
    mixtrim.launches += 1
    return out


mixtrim.launches = 0
