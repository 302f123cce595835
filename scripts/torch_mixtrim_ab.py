#!/usr/bin/env python3
"""Time K2 above 64 workers from two checkouts in turns (A B B A) on one
CUDA card.

    python3 scripts/torch_mixtrim_ab.py [A_CSRC]

A is the K2 entry point of another checkout's sources (``A_CSRC``, default
``build/parent/src/repro_torch/kernels/csrc``: unpack the parent commit
into ``build/parent`` with ``git archive``), its ``mixtrim.cu`` built
alone by nvcc into ``build/ab/``; B is this checkout's kernel library.
Cases: n in (256, 640, 1024), D = 2^20, fp32, trim with f = n // 32, with
a softmax mix and without.  Each build's output is held to the plain
version (1e-5 of the largest |plain|) before it is timed; times are CUDA
events, the median of 5 after a warm-up, in the order A B B A.  Prints one
line per case, the card's name and power limit last.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
OUT = ROOT / "build" / "ab"
CASES = ((256, 1 << 20), (640, 1 << 20), (1024, 1 << 20))


def build_a(csrc: Path) -> ctypes.CDLL:
    from repro_torch.kernels import _build
    OUT.mkdir(parents=True, exist_ok=True)
    lib = OUT / "libmixtrim_a.so"
    done = subprocess.run([_build.find_nvcc(), *_build.COMPILE_FLAGS, "-shared",
                           str(csrc / "mixtrim.cu"), "-o", str(lib)],
                          capture_output=True, text=True)
    if done.returncode:
        raise RuntimeError(f"nvcc failed on A:\n{done.stdout}{done.stderr}")
    a = ctypes.CDLL(str(lib))
    # The signature before the scratch for M^T: (x, dtype, m, n, d, f, med,
    # out, blocks, stream).
    p, i = ctypes.c_void_p, ctypes.c_int
    a.repro_mixtrim.argtypes = [p, i, p, i, ctypes.c_longlong, i, i, p, i, p]
    a.repro_mixtrim.restype = i
    return a


def main(argv) -> int:
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import _build, mixtrim, mixtrim_ref
    from repro_torch.kernels._common import stream_of
    if not torch.cuda.is_available():
        print("torch_mixtrim_ab: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    csrc = Path(argv[0]) if argv else ROOT / "build/parent/src/repro_torch/kernels/csrc"
    lib_a = build_a(csrc)
    _build.library()
    dev = torch.device("cuda")
    rate = cs.mem_rate(torch.cuda.get_device_name(0))
    cap = 16 * _build.sm_count(dev)

    def run_a(x, m, f):
        out = torch.empty(x.shape[1], dtype=torch.float32, device=dev)
        rc = lib_a.repro_mixtrim(x.data_ptr(), 0, None if m is None else m.data_ptr(),
                                 x.shape[0], x.shape[1], f, 0, out.data_ptr(),
                                 cap, stream_of(x))
        if rc:
            raise RuntimeError(f"A: CUDA error {rc}")
        return out

    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    for n, d in CASES:
        f = n // 32
        x = torch.randn((n, d), generator=gen, device=dev)
        m = torch.softmax(torch.randn((n, n), generator=gen, device=dev), -1)
        for mm in (m, None):
            tag = "mix" if mm is not None else "no-mix"
            want = cs.chunked(lambda s: mixtrim_ref(x[:, s], mm, f), d, n)()
            fns = {"A": lambda: run_a(x, mm, f), "B": lambda: mixtrim(x, mm, f)}
            for k, fn in fns.items():
                err, tol = cs.max_err(fn(), want)
                if err > tol:
                    raise AssertionError(f"{k} n={n} {tag}: {err} > {tol}")
            times = [(k, cs.time_ms(fns[k], 5)) for k in "ABBA"]
            flops = (2.0 * n * n * d if mm is not None else 0) + n * d
            bnd = cs.bound(4.0 * n * d + 4 * d + (4 * n * n if mm is not None else 0),
                           flops, rate)
            print(f"K2 trim {tag} n={n} D={d} f={f}: " + ", ".join(
                f"{k} {t:.3f}" for k, t in times) + f" ms; bound {bnd[0]:.3f} ms "
                f"({bnd[1]})", flush=True)
        del x, m
        torch.cuda.empty_cache()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
