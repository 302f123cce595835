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

The fleet and the fed rounds launch K3 on stacks of a few thousand
columns, where a call costs its host path and the latency of its loads,
not bandwidth: the wrapper builds no view and no stream object, and
:func:`launch_geometry` spreads such a lane over the card one column unit
a thread.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._common import (
    check_lanes, check_small, check_stack, device_guard, launch_geometry,
    stream_of,
)


def load_width(x_ptr: int, out_ptr: int, d: int, itemsize: int) -> int:
    """Elements a thread of K3 loads from a row at once: 4, else 2, else 1,
    the widest that divides D and to which the stack's and the output's
    base addresses are aligned (then every row and lane start is too)."""
    for vec in (4, 2):
        if d % vec == 0 and x_ptr % (vec * itemsize) == 0 \
                and out_ptr % (vec * 4) == 0:
            return vec
    return 1


class Plan(ctypes.Structure):
    """``ReproCombinePlan`` of csrc/combine.cu: what a launch at one shape
    passes besides its pointers and stream."""
    _fields_ = [("d", ctypes.c_longlong), ("dtype", ctypes.c_int),
                ("lanes", ctypes.c_int), ("n", ctypes.c_int),
                ("vec", ctypes.c_int), ("threads", ctypes.c_int),
                ("blocks", ctypes.c_int)]


@functools.lru_cache(maxsize=256)
def _plan(d: int, x_align: int, out_align: int, dtype: torch.dtype,
          lanes: int, n: int, device: int) -> tuple[Plan, int]:
    """The plan of a launch and its address, from the shape, the dtype and
    the base addresses' offsets within 16 bytes: the same for every call
    at one shape, so filled once (the cache holds the structure alive; the
    C entry reads it before it returns)."""
    vec = load_width(x_align, out_align, d, dtype.itemsize)
    plan = Plan(d, _build.dtype_code(dtype), lanes, n, vec,
                *launch_geometry(d, vec, _build.sm_count(device)))
    return plan, ctypes.addressof(plan)


def combine_ref(x: torch.Tensor, coeff: torch.Tensor) -> torch.Tensor:
    """Plain version: coeff rounded to X's dtype, then fp32 products and
    sums (the ``tree_combine`` bf16-transport contract)."""
    return coeff.to(x.dtype).float() @ x.float()


def _launch(x: torch.Tensor, coeff: torch.Tensor, coeff_shape: tuple,
            lanes: int, n: int, d: int, out_shape: tuple) -> torch.Tensor:
    """K3 on ``lanes`` (n, d) stacks with ``lanes`` x n coefficients of
    ``coeff_shape`` -> fp32 of ``out_shape`` ((lanes, d), or (d,) for a
    single stack, lane 0 of a one-lane launch)."""
    check_small(coeff, coeff_shape, x, "combine coeff")
    lib = _build.library()
    out = torch.empty(out_shape, dtype=torch.float32, device=x.device)
    x_ptr, out_ptr = x.data_ptr(), out.data_ptr()
    _, plan = _plan(d, x_ptr & 15, out_ptr & 15, x.dtype, lanes, n,
                    x.get_device())
    with device_guard(x):
        rc = lib.repro_combine(x_ptr, coeff.data_ptr(), out_ptr, plan,
                               stream_of(x))
    if rc:
        _build.check(rc, "combine kernel")
    return out


def combine(x: torch.Tensor, coeff: torch.Tensor) -> torch.Tensor:
    """(n, D) fp32 / bf16 and (n,) fp32 -> (D,) fp32."""
    if x.is_cpu:
        return combine_ref(x, coeff)
    check_stack(x, "combine")
    n, d = x.shape
    # The coefficients are checked as coeff.reshape(1, -1): a (n,) vector
    # is checked as it is (the same outcome, without building the view).
    if coeff.shape == (n,):
        out = _launch(x, coeff, (n,), 1, n, d, (d,))
    else:
        out = _launch(x, coeff.reshape(1, -1), (1, n), 1, n, d, (d,))
    combine.launches += 1
    return out


combine.launches = 0


def combine_lanes_ref(x: torch.Tensor, coeff: torch.Tensor) -> torch.Tensor:
    """Plain version of the lane form: :func:`combine_ref` on each lane."""
    return torch.stack([combine_ref(x[k], coeff[k])
                        for k in range(x.shape[0])])


def combine_lanes(x: torch.Tensor, coeff: torch.Tensor) -> torch.Tensor:
    """(B, n, D) fp32 / bf16 and (B, n) fp32 -> (B, D) fp32, every lane in
    one launch (B <= 65535, the grid's y)."""
    if x.is_cpu:
        return combine_lanes_ref(x, coeff)
    check_lanes(x, "combine_lanes")
    lanes, n, d = x.shape
    out = _launch(x, coeff, (lanes, n), lanes, n, d, (lanes, d))
    combine_lanes.launches += 1
    return out


combine_lanes.launches = 0
