"""Build and load the port's CUDA kernels: nvcc -> shared library -> ctypes.

Every ``csrc/*.cu`` file is compiled for ``sm_90a`` by its own ``nvcc``
process, all started together, and the objects are linked into one shared
library with a plain C interface.  The library lands in ``build/kernels``
under the checkout (listed in ``.gitignore``), named by a hash of the
sources and flags, so a second call in the same checkout loads it without
compiling.  Nothing is built or imported when this module is imported:
:func:`library` builds on first use.

The C entry points take raw pointers as ``c_void_p`` and the current CUDA
stream, launch asynchronously and return ``cudaGetLastError()``; the
wrappers raise on a non-zero code (:func:`check`).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
#: <checkout>/build/kernels (this file is src/repro_torch/kernels/_build.py).
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"

ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                              "-Xptxas", "-v")

#: dtype codes of csrc/common.cuh.
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "repro_gram": ([_P, _I, _I, _LL, _P, _I, _P, _P], _I),
    "repro_gram_rows_max_n": ([], _I),
    "repro_gram_tiled": ([_P, _I, _I, _I, _LL, _I, _P, _I, _P, _P], _I),
    "repro_gram_tiled_tm": ([_I], _I),
    "repro_gram_tiled_chunks": ([_I, _I, _LL, _I, _I], _I),
    "repro_gram_tiled_scratch": ([_I, _I, _I, _I], _LL),
    "repro_gram_batched": ([_P, _I, _I, _I, _LL, _P, _I, _P, _P], _I),
    "repro_gram_batched_slots": ([_I], _I),
    "repro_gram_batched_chunks": ([_I, _I, _LL, _I], _I),
    "repro_gram_staged_max_n": ([], _I),
    "repro_mixtrim": ([_P, _I, _P, _P, _I, _LL, _I, _I, _P, _I, _P], _I),
    "repro_mixtrim_dyn": ([_P, _P, _P, _P, _P, _P, _P], _I),
    "repro_mixtrim_max_n": ([], _I),
    "repro_mixtrim_select_scratch": ([_I], _LL),
    "repro_combine": ([_P, _P, _P, _P, _P], _I),
    "repro_bucketgram": ([_P, _P, _P, _P, _P, _P, _P, _P], _I),
    "repro_bucketgram_scratch": ([_P], _LL),
    "repro_bucketgram_reg_nb": ([], _I),
    "repro_bucketgram_means_nb": ([], _I),
    "repro_bucketgram_reg_max_n": ([], _I),
    "repro_error_string": ([_I], ctypes.c_char_p),
}

_LIB: Optional[ctypes.CDLL] = None
#: Compiler output of the library in use (ptxas register and spill report
#: included; kept beside the library, so a cached load has it too), and
#: the wall time in seconds of a build in this process.
BUILD_LOG = ""
BUILD_SECONDS = 0.0


def find_nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (CUDA_HOME/bin/nvcc or PATH): the "
                           "CUDA kernels can only be built on a CUDA host")
    return found


def _digest() -> str:
    """Hash of the flags and of every source and header under csrc."""
    h = hashlib.sha256(" ".join(COMPILE_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile (if needed) and return the path of the shared library."""
    global BUILD_LOG, BUILD_SECONDS
    sources = sorted(CSRC.glob("*.cu"))
    lib = BUILD_DIR / f"librepro_kernels_{_digest()}.so"
    log = lib.with_suffix(".log")
    if lib.exists():
        BUILD_LOG = log.read_text() if log.exists() else ""
        return lib
    nvcc = find_nvcc()
    t0 = time.perf_counter()
    work = BUILD_DIR / f"tmp-{os.getpid()}"
    work.mkdir(parents=True, exist_ok=True)
    try:
        objs, procs = [], []
        for src in sources:
            obj = work / (src.stem + ".o")
            objs.append(obj)
            procs.append(subprocess.Popen(
                [nvcc, *COMPILE_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        logs, failed = [], []
        for src, proc in zip(sources, procs):
            out, _ = proc.communicate()
            logs.append(f"== {src.name} ==\n{out}")
            if proc.returncode != 0:
                failed.append(src.name)
        BUILD_LOG = "\n".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{BUILD_LOG}")
        tmp = work / lib.name
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", *map(str, objs), "-o", str(tmp)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        log.write_text(BUILD_LOG)
        os.replace(tmp, lib)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    BUILD_SECONDS = time.perf_counter() - t0
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        for name, (args, res) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = args, res
        _LIB = lib
    return _LIB


def dtype_code(dtype) -> int:
    try:
        return DTYPE_CODES[dtype]
    except KeyError:
        raise TypeError(f"kernels take float32 or bfloat16 stacks, got {dtype}")


def check(rc: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        msg = library().repro_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


_SM_COUNT: dict = {}


def sm_count(device) -> int:
    """Streaming multiprocessors of a CUDA device (a ``torch.device`` or
    an index; no index: the current device), cached per device index: a
    card's count does not change while the process runs."""
    index = device if isinstance(device, int) else device.index
    if index is None:
        index = torch.cuda.current_device()
    count = _SM_COUNT.get(index)
    if count is None:
        count = _SM_COUNT[index] = (
            torch.cuda.get_device_properties(index).multi_processor_count)
    return count
