"""K2 · fused NNM mix + coordinate-wise trimmed mean / median (static f),
and K4 · its dynamic-f, lane-batched form.

:func:`mixtrim` is the wrapper: for a CUDA stack it launches the kernel of
``csrc/mixtrim.cu`` (the counterpart of the TPU kernel
``repro/kernels/mixtrim/kernel.py::mixtrim_pallas``); for a CPU stack it
runs :func:`mixtrim_ref`, the plain version, which defines the semantics:
values sort with every NaN last (``jnp.sort``'s order, whatever the NaN's
sign: :func:`~repro_torch.kernels._common.sort_nan_last`), so a
trim over the nan / inf attack stacks keeps the same ranks in both.
Up to 64 workers K2 and K4 share one body (``csrc/mixtrim_dyn.cuh``:
several columns a thread, M read as shared-memory broadcasts, a sorting
network cut to the real n; K2 passes f as an argument and sums the slice
of ranks [f, n-f), K4 reads f on the device and applies the rank mask);
from 65 to 1024 workers the mix is a register-tiled fp32 tile product and
a radix select finds the two ranks a trim or a median needs (``csrc/
mixtrim_select.cuh``); above that (to :data:`MAX_N`) a shared-memory
network sorts tiles of columns (``csrc/mixtrim.cuh``).  ``mixtrim.cu`` is
K2's entry point, ``mixtrim_dyn.cu`` K4's.
``mixtrim.launches`` counts kernel launches.

:func:`mixtrim_dyn` (K4, the counterpart of
``repro/kernels/mixtrim/kernel.py::mixtrim_dyn_pallas``) takes f as an int32
tensor on the stack's device, one per lane of a (B, n, D) stack, with an
optional (B, n, n) mixing matrix per lane; :func:`mixtrim_dyn_ref` is its
plain version and defines the semantics of ``mixtrim_dyn_ref`` in the
reference: a rank mask over the sorted stack, so a non-finite value in a
trimmed rank makes its column NaN (inf * 0), unlike K2's slice.
``mixtrim_dyn.launches`` counts kernel launches.

:func:`mixtrim_lanes` is K2's median under the reference's ``jax.vmap``
(the fleet's cwmed lanes, one launch a bucket-round): every lane of a
(B, n, D) stack, with an optional (B, n, n) mix, through K4's entry point
with the median flag (the median reads no f, so K2's and K4's bodies
agree on it), lane b equal to :func:`mixtrim` ``(mode="med")`` on lane b
bit for bit; :func:`mixtrim_lanes_ref` is its plain version,
:func:`mixtrim_ref` on each lane.  ``mixtrim_lanes.launches`` counts its
launches.

K4 and the median lanes launch at the fleet's launch-sized stacks ((5, 17,
2842): read in a fraction of a microsecond), where a call costs its host
path: both take a lean one, a :class:`DynPlan` per shape (cached: the
geometry, the SM count) whose address the seven-argument ``ctypes`` call
passes; the median passes no f; a fp32 contiguous M goes as it is.
``_common.launch_geometry`` spreads a launch-sized lane of the n <= 64
body over the card.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._common import (
    check_lanes, check_small, check_stack, device_guard, launch_geometry,
    sort_nan_last, stream_of,
)

_BLOCKS_PER_SM = 16
#: Largest n of the body K2 and K4 share (csrc/mixtrim.cuh SMALL_N), and
#: its largest block (csrc/mixtrim_dyn.cuh THREADS).
SMALL_N = 64
_SMALL_THREADS = 128
#: Largest worker count the kernels take (csrc/mixtrim.cuh MAX_N): the next
#: power of two above the reference's largest scale n, 10240.
MAX_N = 16384


def sum_rows(y: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum along ``dim`` by pairwise elementwise adds (``dim`` removed).
    Each column's sum depends on that column alone, whereas a reduction
    kernel's order can change with the row's width: a column block of a
    stack (the sharded backends' shard) sums bit for bit as the whole."""
    while y.shape[dim] > 1:
        k = y.shape[dim]
        h = k // 2
        pairs = y.narrow(dim, 0, h) + y.narrow(dim, h, h)
        y = pairs if k % 2 == 0 else torch.cat(
            [pairs, y.narrow(dim, 2 * h, 1)], dim)
    return y.squeeze(dim)


#: Columns the plain version mixes and sorts at a time.  Every column is
#: its own, so the result is the whole's; the mix's and the sort's
#: temporaries (several copies of the stack at once) stay this wide, as
#: the kernel keeps none (``launch.dryrun`` reckons a rank's peak with
#: the plain version).
PLAIN_COLS = 1 << 22


def mixtrim_ref(x: torch.Tensor, m: Optional[torch.Tensor], f: int,
                mode: str = "trim") -> torch.Tensor:
    """Plain version: Y = M @ X in fp32 (X alone when ``m`` is None), then
    the mean of sorted ranks [f, n-f) (the mean of Y when f == 0; sums by
    :func:`sum_rows`) or the median; (D,) fp32, :data:`PLAIN_COLS`
    columns at a time."""
    n, d = x.shape
    if d > PLAIN_COLS:
        out = torch.empty((d,), dtype=torch.float32, device=x.device)
        for c in range(0, d, PLAIN_COLS):
            out[c:c + PLAIN_COLS] = mixtrim_ref(x[:, c:c + PLAIN_COLS], m, f,
                                                mode)
        return out
    y = x.float() if m is None else m.float() @ x.float()
    if mode == "trim":
        if f == 0:
            return sum_rows(y, 0) / n
        return sum_rows(sort_nan_last(y, 0)[f: n - f], 0) / (n - 2 * f)
    if mode == "med":
        ys = sort_nan_last(y, 0)
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
    mf, mt = _mix_operands(m, (n, n), x, "mixtrim m")
    lib = _build.library()
    # The kernels cap the column blocks at what one wave needs themselves.
    blocks = _BLOCKS_PER_SM * _build.sm_count(x.device)
    out = torch.empty((d,), dtype=torch.float32, device=x.device)
    with device_guard(x):
        rc = lib.repro_mixtrim(x.data_ptr(), _build.dtype_code(x.dtype),
                               _ptr(mf), _ptr(mt), n, d, int(f),
                               int(mode == "med"), out.data_ptr(), blocks,
                               stream_of(x))
    _build.check(rc, "mixtrim kernel")
    mixtrim.launches += 1
    return out


mixtrim.launches = 0


def _mix_operands(m, shape: tuple, x: torch.Tensor, what: str):
    """(fp32 M, scratch for M^T): the scratch only where the tiled mix
    (64 < n <= 1024) stages M transposed and padded to its tile, sized by
    the library; None without M."""
    if m is None:
        return None, None
    mf = m if m.dtype == torch.float32 and m.is_contiguous() \
        else m.float().contiguous()
    check_small(mf, shape, x, what)
    words = _scratch_words(shape[-1])
    lanes = shape[0] if len(shape) == 3 else 1
    mt = torch.empty((lanes * words,), dtype=torch.float32,
                     device=x.device) if words else None
    return mf, mt


@functools.lru_cache(maxsize=None)
def _scratch_words(n: int) -> int:
    """fp32 words of M^T scratch a lane takes at n (0 outside the tiled
    mix's 64 < n <= 1024), asked of the library once per n."""
    return _build.library().repro_mixtrim_select_scratch(n)


def cols_per_thread(n: int) -> int:
    """Columns a thread of the n <= 64 body owns (csrc/mixtrim_dyn.cuh
    ``cols_per_thread``, the same in fp32 and bf16): 4 to 8 workers, 2 to
    20, else 1."""
    return 4 if n <= 8 else 2 if n <= 20 else 1


class DynPlan(ctypes.Structure):
    """``ReproMixtrimDynPlan`` of csrc/mixtrim_dyn.cu: what a K4 / median
    lanes launch at one shape passes besides its pointers and stream."""
    _fields_ = [("d", ctypes.c_longlong), ("dtype", ctypes.c_int),
                ("lanes", ctypes.c_int), ("n", ctypes.c_int),
                ("med", ctypes.c_int), ("threads", ctypes.c_int),
                ("blocks", ctypes.c_int), ("sms", ctypes.c_int)]


@functools.lru_cache(maxsize=256)
def _dyn_plan(d: int, dtype: torch.dtype, lanes: int, n: int, med: bool,
              device: int) -> tuple[DynPlan, int]:
    """The plan of a launch and its address (the cache holds the structure
    alive; the C entry reads it before it returns).  Above 64 workers the
    bodies take their own geometry: ``blocks`` caps their column blocks
    per lane, as before."""
    sms = _build.sm_count(device)
    if n <= SMALL_N:
        threads, blocks = launch_geometry(d, cols_per_thread(n), sms,
                                          _SMALL_THREADS)
    else:
        threads, blocks = _SMALL_THREADS, max(1, _BLOCKS_PER_SM * sms // lanes)
    plan = DynPlan(d, _build.dtype_code(dtype), lanes, n, int(med), threads,
                   blocks, sms)
    return plan, ctypes.addressof(plan)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _lane_f(f, lanes: int, device) -> torch.Tensor:
    """f as a (lanes,) int32 tensor on ``device`` (a Python int or a
    0-d / (lanes,) tensor); the fleet's (lanes,) contiguous int32 f on the
    stack's card is taken as it is."""
    if isinstance(f, torch.Tensor) and f.dtype == torch.int32 \
            and f.shape == (lanes,) and f.is_contiguous() \
            and f.device == device:
        return f
    t = torch.as_tensor(f, device=device)
    if t.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"f must be an integer tensor, got {t.dtype}")
    t = t.to(device=device, dtype=torch.int32).reshape(-1)
    if t.numel() == 1 and lanes > 1:
        t = t.expand(lanes)
    if t.shape != (lanes,):
        raise ValueError(f"f must hold one value per lane ({lanes}), got "
                         f"{tuple(t.shape)}")
    return t.contiguous()


def _as_lanes(x, m, f):
    """(x, m, f, batched): a (n, D) call as one lane of a (1, n, D) call."""
    if x.dim() == 3:
        return x, m, f, True
    return (x[None], None if m is None else m[None],
            torch.as_tensor(f).reshape(1), False)


def mixtrim_dyn_ref(x: torch.Tensor, m: Optional[torch.Tensor], f,
                    mode: str = "trim") -> torch.Tensor:
    """Plain version of K4: Y = M @ X per lane in fp32 (X alone when ``m``
    is None), a NaN-last sort along the worker axis, then ``"trim"``: the
    sum of ys[r] * keep[r] over all n ranks (:func:`sum_rows`), keep =
    (r >= f) & (r < n - f), over max(n - 2f, 1); ``"med"``: the median (f
    unused).  x is (B, n, D)
    with (B, n, n) m and (B,) f, or (n, D) with (n, n) m and a scalar f;
    returns (B, D) / (D,) fp32."""
    x, m, f, batched = _as_lanes(x, m, f)
    n = x.shape[1]
    y = x.float() if m is None else m.float() @ x.float()
    ys = sort_nan_last(y, 1)
    if mode == "trim":
        f = _lane_f(f, x.shape[0], x.device).reshape(-1, 1, 1)
        i = torch.arange(n, device=x.device).reshape(1, n, 1)
        keep = ((i >= f) & (i < n - f)).float()
        denom = torch.clamp_min((n - 2 * f).float(), 1.0)[:, 0]
        out = sum_rows(ys * keep, 1) / denom
    elif mode == "med":
        if n % 2 == 1:
            out = ys[:, n // 2]
        else:
            out = 0.5 * (ys[:, n // 2 - 1] + ys[:, n // 2])
    else:
        raise ValueError(mode)
    return out if batched else out[0]


def mixtrim_dyn(x: torch.Tensor, m: Optional[torch.Tensor], f,
                mode: str = "trim") -> torch.Tensor:
    """(B, n, D) fp32 / bf16, optional (B, n, n) mixing matrices and a (B,)
    int32 f on the device -> (B, D) fp32, all lanes in one launch; a (n, D)
    stack with a scalar f is one lane.  f is read by the kernel, never by
    the host."""
    if mode not in ("trim", "med"):
        raise ValueError(f"mode must be 'trim' or 'med', got {mode!r}")
    if x.is_cpu:
        return mixtrim_dyn_ref(x, m, f, mode)
    x, m, f, batched = _as_lanes(x, m, f)
    check_lanes(x, "mixtrim_dyn")
    out = _launch_lanes(x, m, _lane_f(f, x.shape[0], x.device),
                        mode == "med", "mixtrim_dyn")
    mixtrim_dyn.launches += 1
    return out if batched else out[0]


def _launch_lanes(x: torch.Tensor, m: Optional[torch.Tensor],
                  fd: Optional[torch.Tensor], med: bool,
                  what: str) -> torch.Tensor:
    """K4's entry point on a (B, n, D) stack: (B,) int32 f on the device
    (None: the median lanes, which make none), optional (B, n, n) M, the
    median flag -> (B, D) fp32."""
    lanes, n, d = x.shape
    if n > MAX_N:
        raise ValueError(f"{what} kernel takes n <= {MAX_N} workers, got "
                         f"n={n} (the port's one limit, ROADMAP queue 3)")
    mf, mt = _mix_operands(m, (lanes, n, n), x, f"{what} m")
    lib = _build.library()
    _, plan = _dyn_plan(d, x.dtype, lanes, n, med, x.get_device())
    out = torch.empty((lanes, d), dtype=torch.float32, device=x.device)
    with device_guard(x):
        rc = lib.repro_mixtrim_dyn(x.data_ptr(), _ptr(mf), _ptr(mt), _ptr(fd),
                                   out.data_ptr(), plan, stream_of(x))
    if rc:
        _build.check(rc, f"{what} kernel")
    return out


mixtrim_dyn.launches = 0


def mixtrim_lanes_ref(x: torch.Tensor, m: Optional[torch.Tensor]
                      ) -> torch.Tensor:
    """Plain version of the median lanes: :func:`mixtrim_ref`'s median on
    each lane of a (B, n, D) stack (with lane k's M when given)."""
    return torch.stack([mixtrim_ref(x[k], None if m is None else m[k], 0,
                                    "med") for k in range(x.shape[0])])


def mixtrim_lanes(x: torch.Tensor, m: Optional[torch.Tensor]) -> torch.Tensor:
    """(B, n, D) fp32 / bf16, optional (B, n, n) mixing matrices -> (B, D)
    fp32: every lane's coordinate-wise median in one launch (K4's entry
    point with ``med = 1`` and no f)."""
    if x.is_cpu:
        return mixtrim_lanes_ref(x, m)
    check_lanes(x, "mixtrim_lanes")
    out = _launch_lanes(x, m, None, True, "mixtrim_lanes")
    mixtrim_lanes.launches += 1
    return out


mixtrim_lanes.launches = 0
