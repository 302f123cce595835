#!/usr/bin/env python3
"""Time K2 from two checkouts in turns (A B B A) on one CUDA card.

    python3 scripts/torch_mixtrim_ab.py [A_CSRC] [--small | --large | --grid]

A is the K2 entry point of another checkout's sources (``A_CSRC``, default
``build/parent/src/repro_torch/kernels/csrc``: unpack the parent commit
into ``build/parent`` with ``git archive``): its ``mixtrim*.cu`` files,
each compiled by its own nvcc process (all started together, while this
checkout's library builds) and linked into ``build/ab/``; B is this
checkout's kernel library.  Cases, trim with the mix (a softmax matrix)
and without:
  --small: n = 8 at the dense main path's D = 361,821,120, fp32 and bf16,
           f = 2; n = 17 at D = 2^24 + 3, f = 8; n = 33, 48 and 64 at
           D = 2^24, f = n // 4 (fp32 and bf16);
  --large: n in (256, 640, 1024), D = 2^20, fp32, f = n // 32;
  --grid: the fleet grid's cwmed lanes, the median at n = 17 and 9,
          D = 2842, fp32, each time the mean over a run of 500 calls of
          each build's C entry point through ctypes (launch and host
          cost included, the same Python around both);
--small and --large by default.  Each build's output is held to the
plain version (1e-5 of the largest |plain|) before it is timed; times are
CUDA events, the median of 5 after a warm-up, in the order A B B A.
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
#: (n, D, f, dtypes).
SMALL = ((8, 361_821_120, 2, ("fp32", "bf16")), (17, (1 << 24) + 3, 8, ("fp32",)),
         (33, 1 << 24, 8, ("fp32", "bf16")), (48, 1 << 24, 12, ("fp32", "bf16")),
         (64, 1 << 24, 16, ("fp32", "bf16")))
LARGE = tuple((n, 1 << 20, n // 32, ("fp32",)) for n in (256, 640, 1024))
GRID = ((17, 2842, 0, ("fp32",)), (9, 2842, 0, ("fp32",)))
GRID_CALLS = 500


def start_a(csrc: Path):
    """Start one nvcc process per ``mixtrim*.cu`` of A; (objects, processes)."""
    from repro_torch.kernels import _build
    OUT.mkdir(parents=True, exist_ok=True)
    objs, procs = [], []
    for src in sorted(csrc.glob("mixtrim*.cu")):
        obj = OUT / f"a_{src.stem}.o"
        objs.append(obj)
        procs.append(subprocess.Popen(
            [_build.find_nvcc(), *_build.COMPILE_FLAGS, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return objs, procs


def finish_a(objs, procs) -> ctypes.CDLL:
    from repro_torch.kernels import _build
    for proc in procs:
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on A:\n{out}")
    lib = OUT / "libmixtrim_a.so"
    done = subprocess.run([_build.find_nvcc(), *_build.ARCH_FLAGS, "-shared",
                           *map(str, objs), "-o", str(lib)],
                          capture_output=True, text=True)
    if done.returncode:
        raise RuntimeError(f"nvcc link failed on A:\n{done.stdout}{done.stderr}")
    a = ctypes.CDLL(str(lib))
    # (x, dtype, m, mt, n, d, f, med, out, blocks, stream), as B's.
    p, i = ctypes.c_void_p, ctypes.c_int
    a.repro_mixtrim.argtypes = [p, i, p, p, i, ctypes.c_longlong, i, i, p, i, p]
    a.repro_mixtrim.restype = i
    a.repro_mixtrim_select_scratch.argtypes = [i]
    a.repro_mixtrim_select_scratch.restype = ctypes.c_longlong
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
    flags = {a for a in argv if a.startswith("--")}
    paths = [a for a in argv if not a.startswith("--")]
    if not flags <= {"--small", "--large", "--grid"}:
        print(f"torch_mixtrim_ab: unknown options {sorted(flags)}", file=sys.stderr)
        return 2
    flags = flags or {"--small", "--large"}
    grid = "--grid" in flags
    cases = ((SMALL if "--small" in flags else ()) + (LARGE if "--large" in flags else ())
             + (GRID if grid else ()))
    csrc = Path(paths[0]) if paths else ROOT / "build/parent/src/repro_torch/kernels/csrc"
    pending = start_a(csrc)
    _build.library()
    lib_a = finish_a(*pending)
    dev = torch.device("cuda")
    rate = cs.mem_rate(torch.cuda.get_device_name(0))
    cap = 16 * _build.sm_count(dev)

    def run(lib, x, m, mt, f, med):
        out = torch.empty(x.shape[1], dtype=torch.float32, device=dev)
        rc = lib.repro_mixtrim(x.data_ptr(), _build.dtype_code(x.dtype),
                               None if m is None else m.data_ptr(),
                               None if mt is None else mt.data_ptr(),
                               x.shape[0], x.shape[1], f, med, out.data_ptr(),
                               cap, stream_of(x))
        if rc:
            raise RuntimeError(f"CUDA error {rc}")
        return out

    def calls(fn):
        def run():
            for _ in range(GRID_CALLS):
                fn()
        return run

    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    for n, d, f, dtypes in cases:
        x32 = torch.randn((n, d), generator=gen, device=dev)
        m = torch.softmax(torch.randn((n, n), generator=gen, device=dev), -1)
        words = lib_a.repro_mixtrim_select_scratch(n)
        mt = torch.empty(words, device=dev) if words else None
        for dt in dtypes:
            x = x32 if dt == "fp32" else x32.to(torch.bfloat16)
            el = x.element_size()
            for mm in (m, None):
                tag = "mix" if mm is not None else "no-mix"
                mx = None if mm is None else mm.to(x.dtype).float()
                mode = "med" if d == 2842 else "trim"
                med = int(mode == "med")
                want = cs.chunked(lambda s: mixtrim_ref(x[:, s], mx, f, mode), d, n)()
                fns = {"A": lambda: run(lib_a, x, mx, mt, f, med),
                       "B": lambda: mixtrim(x, mx, f, mode)}
                for k, fn in fns.items():
                    err, tol = cs.max_err(fn(), want)
                    if err > tol:
                        raise AssertionError(f"{k} n={n} {dt} {tag}: {err} > {tol}")
                del want
                if med:
                    fns = {"A": calls(lambda: run(lib_a, x, mx, mt, f, med)),
                           "B": calls(lambda: run(_build.library(), x, mx, mt,
                                                  f, med))}
                times = [(k, cs.time_ms(fns[k], 5) / (GRID_CALLS if med else 1))
                         for k in "ABBA"]
                flops = (2.0 * n * n * d if mm is not None else 0) + n * d
                bnd = cs.bound(1.0 * el * n * d + 4 * d
                               + (4 * n * n if mm is not None else 0), flops, rate)
                print(f"K2 {mode} {tag} n={n} D={d} f={f} {dt}: " + ", ".join(
                    f"{k} {t:.3f}" for k, t in times) + f" ms; bound {bnd[0]:.3f} ms "
                    f"({bnd[1]})", flush=True)
            del x
        del x32, m, mt
        torch.cuda.empty_cache()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
