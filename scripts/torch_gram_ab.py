#!/usr/bin/env python3
"""Time K1 (gram) from two checkouts in turns (A B B A) on one CUDA card,
or this checkout's tiled product at every tile height.

    python3 scripts/torch_gram_ab.py [A_CSRC]
    python3 scripts/torch_gram_ab.py --tiles

A is the K1 entry point of another checkout's sources (``A_CSRC``, default
``build/parent/src/repro_torch/kernels/csrc``: unpack the parent commit
into ``build/parent`` with ``git archive``), its ``gram.cu`` built alone by
nvcc into ``build/ab/`` and called with that source's entry point
(``repro_gram(x, dtype, lanes, n, d, partial, chunks, g, stream)``, the
8-row tile pairs); B is this checkout's ``gram`` wrapper.  Cases: n in
(64, 256, 640, 1024), D = 2^20, fp32.  Each build's output is held to the
plain version (1e-5 of the largest |plain|) before it is timed; times are
CUDA events, the median of 5 after a warm-up, in the order A B B A.

``--tiles`` times this checkout's tiled product (n > 32) at each tile
height TM in (32, 64, 128) for n in TILE_NS, D = 2^20, fp32, in turns, each
held to the plain version first, beside torch.mm(x, x.T) and the bound: the
measurement behind ``repro_gram_tiled_tm(n)``'s crossover
(``scripts/torch_kernel_variants.py K1`` times the tiled product's other
build constants).

Prints one line per case, the card's name and power limit last.
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
D = 1 << 20
CASES = (64, 256, 640, 1024)
TILE_NS = (33, 40, 48, 64, 65, 96, 128, 129, 192, 256, 384, 640, 1024)


def build_a(csrc: Path) -> ctypes.CDLL:
    from repro_torch.kernels import _build
    OUT.mkdir(parents=True, exist_ok=True)
    lib = OUT / "libgram_a.so"
    done = subprocess.run([_build.find_nvcc(), *_build.COMPILE_FLAGS, "-shared",
                           str(csrc / "gram.cu"), "-o", str(lib)],
                          capture_output=True, text=True)
    if done.returncode:
        raise RuntimeError(f"nvcc failed on A:\n{done.stdout}{done.stderr}")
    a = ctypes.CDLL(str(lib))
    p, i = ctypes.c_void_p, ctypes.c_int
    a.repro_gram.argtypes = [p, i, i, i, ctypes.c_longlong, p, i, p, p]
    a.repro_gram.restype = i
    a.repro_gram_pairs.argtypes = [i]
    a.repro_gram_pairs.restype = i
    return a


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]


def ab(argv) -> None:
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import _build, gram, gram_ref
    from repro_torch.kernels._common import stream_of
    csrc = Path(argv[0]) if argv else ROOT / "build/parent/src/repro_torch/kernels/csrc"
    lib_a = build_a(csrc)
    dev = torch.device("cuda")
    rate = cs.mem_rate(torch.cuda.get_device_name(0))
    sms = _build.sm_count(dev)

    def run_a(x):
        n, d = x.shape
        pairs = lib_a.repro_gram_pairs(n)
        units = d // 4 if d % 4 == 0 else d
        chunks = max(1, min(-(-units // 256), 8 * sms // pairs))
        part = torch.empty(chunks * pairs * 64, dtype=torch.float32, device=dev)
        g = torch.empty((n, n), dtype=torch.float32, device=dev)
        rc = lib_a.repro_gram(x.data_ptr(), 0, 1, n, d, part.data_ptr(), chunks,
                              g.data_ptr(), stream_of(x))
        if rc:
            raise RuntimeError(f"A: CUDA error {rc}")
        return g

    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    for n in CASES:
        x = torch.randn((n, D), generator=gen, device=dev)
        want = gram_ref(x)
        fns = {"A": lambda: run_a(x), "B": lambda: gram(x)}
        for k, fn in fns.items():
            err, tol = cs.max_err(fn(), want)
            if err > tol:
                raise AssertionError(f"{k} n={n}: {err} > {tol}")
        times = [(k, cs.time_ms(fns[k], 5)) for k in "ABBA"]
        lib = cs.time_ms(lambda: torch.mm(x, x.T), 5)
        bnd = cs.bound(4.0 * n * D + 4 * n * n, n * (n + 1) * D, rate)
        print(f"K1 n={n} D={D}: " + ", ".join(f"{k} {t:.3f}" for k, t in times)
              + f" ms; torch.mm {lib:.3f} ms; bound {bnd[0]:.3f} ms ({bnd[1]})",
              flush=True)
        del x, want
        torch.cuda.empty_cache()


def tiles() -> None:
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import _build, gram_ref
    from repro_torch.kernels.gram.ops import _launch_tiled
    dev = torch.device("cuda")
    rate = cs.mem_rate(torch.cuda.get_device_name(0))
    lib = _build.library()
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    for n in TILE_NS:
        x = torch.randn((n, D), generator=gen, device=dev)
        want = gram_ref(x)
        runs = {tm: (lambda tm=tm: _launch_tiled(x[None], 1, n, D, tm)[0])
                for tm in (32, 64, 128)}
        for tm, fn in runs.items():
            err, tol = cs.max_err(fn(), want)
            if err > tol:
                raise AssertionError(f"TM={tm} n={n}: {err} > {tol}")
        times = {tm: [] for tm in runs}
        for order in ((32, 64, 128), (128, 64, 32)):
            for tm in order:
                times[tm].append(cs.time_ms(runs[tm], 5))
        mm = cs.time_ms(lambda: torch.mm(x, x.T), 5)
        bnd = cs.bound(4.0 * n * D + 4 * n * n, n * (n + 1) * D, rate)
        pick = lib.repro_gram_tiled_tm(n)
        print(f"K1 tiled n={n} D={D}: " + ", ".join(
            f"TM={tm}{'*' if tm == pick else ''} {min(t):.3f}" for tm, t in times.items())
            + f" ms (turns {times}); torch.mm {mm:.3f} ms; bound {bnd[0]:.3f} ms "
            f"({bnd[1]})", flush=True)
        del x, want
        torch.cuda.empty_cache()


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_gram_ab: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    if argv[:1] == ["--tiles"]:
        tiles()
    else:
        ab(argv)
    print(card())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
