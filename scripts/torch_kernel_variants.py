#!/usr/bin/env python3
"""Time variants of the port's K5 (staged gram_batched) and K4 (mixtrim_dyn
n <= 64 body) at the fleet's scale shape, (B, n, D) = (8, 17, 2^24), of
the same n <= 64 body as K2 runs it (K2small: f from the host, the slice
of ranks [f, n - f)) at the dense main path's shape (n = 8, D =
361,821,120, fp32 and bf16) and at n = 17, 33, 48 and 64, of K2's
64 < n <= 1024 body (mixtrim_select) and of K1's tiled product at
TM = 128 (gram_tiled) at n = 256, 640 and 1024, D = 2^20, on one CUDA card.

    python3 scripts/torch_kernel_variants.py [K1] [K2] [K2small] [K4] [K5]

With no argument every kernel's variants run; otherwise those named.

Each variant is a copy of the committed source (src/repro_torch/kernels/
csrc) with one or two of its compile-time constants replaced, built by nvcc
into build/variants/ (all builds in parallel) and loaded with ctypes.  K5:
the tile width TC and the ring depth STAGES; K4 at n = 17: the columns a
thread owns and the threads a block; K2small: eight bf16 columns a thread
at n <= 8 (16-byte loads), and the mix instances with one column a
thread (n > 20) without their shared-memory staging of the mixed rows; K2: the committed body and, for
timing only, the same body with the rank selection replaced by the
column's mean (its time is the product's and the staging's share; its
output is not a trim and is not checked); K1: the committed body, its
second-level sums in registers in place of shared memory, and other
stage widths and ring depths.  Every other variant is held to
the plain version (1e-5 of the largest |plain|) before it is timed; times
are CUDA events, the median of 7 after a warm-up, the variants of a kernel
taken in turns.  Prints one line per variant, the card's name and power
limit last.
"""
from __future__ import annotations

import ctypes
import re
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
OUT = ROOT / "build" / "variants"
SHAPE = (8, 17, 1 << 24)

#: name -> {regular expression matching a constant's definition in the
#: committed source: its replacement}; {} is the committed source itself.
K5_VARIANTS = {
    f"K5 TC={tc} STAGES={st}": {r"constexpr int TC = \d+;": f"constexpr int TC = {tc};",
                                r"constexpr int STAGES = \d+;": f"constexpr int STAGES = {st};"}
    for tc in (128, 256) for st in (3, 4)
}
_CPT = (r"return n <= 8 \? \(bytes == 2 \? SMALL_C_BF16 : 4\) : "
        r"\(n <= 20 \? 2 : 1\);")
K4_VARIANTS = {
    "K4 C=2 THREADS=128": {},
    "K4 C=4 THREADS=128": {_CPT: "return n <= 20 ? 4 : 1;"},
    "K4 C=1 THREADS=128": {_CPT: "return n <= 8 ? 4 : 1;"},
    "K4 C=2 THREADS=256": {r"constexpr int THREADS = 128;": "constexpr int THREADS = 256;"},
}
K4_ENTRY = """
#include "mixtrim_dyn.cuh"
using namespace mixtrim_dyn_detail;
extern "C" int variant_k4(const void* x, int dtype, const float* m, int lanes,
                          int n, long long d, const int* f, int med,
                          float* out, int blocks, void* s) {
  const Args a{x, dtype, m, lanes, n, d, f, 0, med, out, blocks,
               static_cast<cudaStream_t>(s)};
  return launch_n<17>(a);
}
"""
K2S_VARIANTS = {
    "K2small committed": {},
    "K2small C=8 bf16": {r"constexpr int SMALL_C_BF16 = \d+;":
                         "constexpr int SMALL_C_BF16 = 8;"},
    "K2small no staging": {r"constexpr bool STAGE_MIX = \w+;":
                           "constexpr bool STAGE_MIX = false;"},
}
K2S_ENTRY = """
#include "mixtrim_dyn.cuh"
namespace mixtrim_dyn_detail {
int launch_small(const Args& a) {
  if (a.n == 8) return launch_n<8>(a);
  if (a.n == 17) return launch_n<17>(a);
  if (a.n > 32 && a.n <= 48) return launch_n<48>(a);
  if (a.n > 48 && a.n <= 64) return launch_n<64>(a);
  return cudaErrorInvalidValue;
}
}  // namespace mixtrim_dyn_detail
extern "C" int variant_k2s(const void* x, int dtype, const float* m, int n,
                           long long d, int f, float* out, int blocks,
                           void* s) {
  return mixtrim_dyn_detail::launch_small(
      {x, dtype, m, 1, n, d, nullptr, f, 0, out, blocks,
       static_cast<cudaStream_t>(s)});
}
"""
#: K2small's shapes: (n, D, f); the first is the dense main path's.
K2S_SHAPES = ((8, 361_821_120, 2), (17, (1 << 24) + 3, 8), (33, 1 << 24, 8),
              (48, 1 << 24, 12), (64, 1 << 24, 16))


_SEL = r"column_result\({}keys \+ c \* kp, n, f, med, dyn, hist, lane\)"
K2_VARIANTS = {
    "K2 committed": {},
    "K2 mix only": {_SEL.format(p): f"column_result({p}keys + c * kp, n, 0, 0, "
                                    "false, hist, lane)" for p in ("", "nm_")},
}
K2_ENTRY = """
#include "mixtrim_select.cu"
#include "mixtrim_select_bf16.cu"
extern "C" int variant_k2(const void* x, const float* m, float* mt, int n,
                          long long d, int f, float* out, int blocks, void* s) {
  return mixtrim_select::launch({x, REPRO_F32, m, mt, 1, n, d, f, nullptr, 0,
                                 out, blocks, static_cast<cudaStream_t>(s)});
}
"""
K2_SHAPES = ((256, 1 << 20), (640, 1 << 20), (1024, 1 << 20))
_K1_CFG = r"static constexpr int KT = 32, STAGES = 4, BLOCKS = 1;"
K1_VARIANTS = {
    "K1 committed": {},
    "K1 sums in registers": {r"static constexpr bool SUM_SMEM = true;":
                             "static constexpr bool SUM_SMEM = false;"},
    "K1 KT=16 STAGES=6": {_K1_CFG: "static constexpr int KT = 16, STAGES = 6, "
                                   "BLOCKS = 1;"},
    "K1 STAGES=3": {_K1_CFG: "static constexpr int KT = 32, STAGES = 3, "
                             "BLOCKS = 1;"},
}
K1_NS = (640, 1024, 256)


def _copy(name: str, files: dict, subs: dict) -> Path:
    """build/variants/<name>/ holding the sources with ``subs`` applied
    (each pattern matches at most once)."""
    d = OUT / re.sub(r"[^A-Za-z0-9]+", "_", name)
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    for fname, text in files.items():
        for pat, new in subs.items():
            hits = len(re.findall(pat, text))
            if hits > 1:
                raise RuntimeError(f"{name}: {pat!r} is not unique in {fname}")
            text = re.sub(pat, new, text)
        (d / fname).write_text(text)
    return d


def build_all(which) -> dict:
    from repro_torch.kernels import _build
    nvcc = _build.find_nvcc()
    common = (CSRC / "common.cuh").read_text()
    jobs = {}
    for name, subs in K1_VARIANTS.items() if "K1" in which else ():
        jobs[name] = _copy(name, {"common.cuh": common,
                                  "k.cu": (CSRC / "gram.cu").read_text()}, subs)
    for name, subs in K5_VARIANTS.items() if "K5" in which else ():
        d = _copy(name, {"common.cuh": common,
                         "k.cu": (CSRC / "gram_batched.cu").read_text()}, subs)
        jobs[name] = d
    for name, subs in K4_VARIANTS.items() if "K4" in which else ():
        d = _copy(name, {"common.cuh": common,
                         "sortnet.cuh": (CSRC / "sortnet.cuh").read_text(),
                         "mixtrim_dyn.cuh": (CSRC / "mixtrim_dyn.cuh").read_text(),
                         "k.cu": K4_ENTRY}, subs)
        jobs[name] = d
    for name, subs in K2S_VARIANTS.items() if "K2small" in which else ():
        jobs[name] = _copy(name, {"common.cuh": common,
                                  "sortnet.cuh": (CSRC / "sortnet.cuh").read_text(),
                                  "mixtrim_dyn.cuh": (CSRC / "mixtrim_dyn.cuh").read_text(),
                                  "k.cu": K2S_ENTRY}, subs)
    k2_files = {f: (CSRC / f).read_text() for f in (
        "mixtrim.cuh", "mixtrim_select.cuh", "mixtrim_select.cu",
        "mixtrim_select_bf16.cu")}
    for name, subs in K2_VARIANTS.items() if "K2" in which else ():
        jobs[name] = _copy(name, {"common.cuh": common, **k2_files,
                                  "k.cu": K2_ENTRY}, subs)
    procs = {name: subprocess.Popen(
        [nvcc, *_build.COMPILE_FLAGS, "-shared", str(d / "k.cu"), "-o",
         str(d / "k.so")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for name, d in jobs.items()}
    libs = {}
    for name, p in procs.items():
        out, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed\n{out}")
        regs = re.findall(r"Used (\d+) registers", out)
        stack = re.findall(r"(\d+) bytes stack frame", out)
        print(f"{name}: built; ptxas registers {sorted(set(regs))}, stack "
              f"{sorted(set(stack))}", flush=True)
        libs[name] = ctypes.CDLL(str(jobs[name] / "k.so"))
    return libs


def time_ms(fn, reps: int = 7) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        fn()
        e.record()
        e.synchronize()
        out.append(s.elapsed_time(e))
    return statistics.median(out)


def close(got, want) -> float:
    err = float((got - want).abs().max())
    tol = 1e-5 * float(want.abs().max())
    if not err <= tol:
        raise AssertionError(f"variant off by {err} (tol {tol})")
    return err


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_kernel_variants: no CUDA device", file=sys.stderr)
        return 1
    kinds = {"K1", "K2", "K2small", "K4", "K5"}
    which = set(argv) or kinds
    if not which <= kinds:
        print(f"torch_kernel_variants: unknown kernels {sorted(which)}",
              file=sys.stderr)
        return 2
    libs = build_all(which)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    if which & {"K4", "K5"}:
        fleet_variants(libs, dev, gen, sms)
    if "K2small" in which:
        k2_small_variants(libs, dev, gen, sms)
    if "K2" in which:
        k2_variants(libs, dev, gen, sms)
    if "K1" in which:
        k1_variants(libs, dev, gen, sms)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    print(card)
    return 0


def fleet_variants(libs, dev, gen, sms) -> None:
    """K5's and K4's variants at SHAPE, in turns (those that were built)."""
    import torch
    from repro_torch.kernels import gram_batched_ref, mixtrim_dyn_ref
    from repro_torch.kernels._common import stream_of
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    b, n, d = SHAPE
    x = torch.randn(SHAPE, generator=gen, device=dev)
    bound = 1e3 * 4.0 * b * n * d / 3.35e12

    runs = {}
    want = torch.stack([gram_batched_ref(x[k:k + 1])[0] for k in range(b)])
    for name in (k for k in K5_VARIANTS if k in libs):
        lib = libs[name]
        lib.repro_gram_batched.argtypes = [P, I, I, I, LL, P, I, P, P]
        lib.repro_gram_batched_chunks.argtypes = [I, I, LL, I]
        chunks = lib.repro_gram_batched_chunks(b, n, d, sms)
        part = torch.empty(b * chunks * lib.repro_gram_batched_slots(n),
                           device=dev)
        g = torch.empty((b, n, n), device=dev)

        def run(lib=lib, chunks=chunks, part=part, g=g):
            rc = lib.repro_gram_batched(x.data_ptr(), 0, b, n, d,
                                        part.data_ptr(), chunks, g.data_ptr(),
                                        stream_of(x))
            assert rc == 0, rc
            return g
        close(run(), want)
        runs[name] = run
    f = torch.arange(b, dtype=torch.int32, device=dev)
    m = torch.softmax(torch.randn((b, n, n), generator=gen, device=dev), -1)
    want4 = {tag: torch.cat([mixtrim_dyn_ref(x[:, :, c:c + (1 << 22)].contiguous(),
                                             mm, f)
                             for c in range(0, d, 1 << 22)], dim=1)
             for tag, mm in (("mix", m), ("no-mix", None))}
    for name in (k for k in K4_VARIANTS if k in libs):
        lib = libs[name]
        lib.variant_k4.argtypes = [P, I, P, I, I, LL, P, I, P, I, P]
        for tag, mm in (("mix", m), ("no-mix", None)):
            out = torch.empty((b, d), device=dev)

            def run(lib=lib, mm=mm, out=out):
                rc = lib.variant_k4(x.data_ptr(), 0,
                                    None if mm is None else mm.data_ptr(), b,
                                    n, d, f.data_ptr(), 0, out.data_ptr(),
                                    16 * sms // b, stream_of(x))
                assert rc == 0, rc
                return out
            close(run(), want4[tag])
            runs[f"{name} {tag}"] = run
    times = {k: [] for k in runs}
    for _ in range(2):                   # two turns through every variant
        for k, fn in runs.items():
            times[k].append(time_ms(fn))
    for k, ts in times.items():
        print(f"{k}: {min(ts):.3f} ms (turns {', '.join(f'{t:.3f}' for t in ts)})"
              + (f", {100 * bound / min(ts):.0f} % of the {bound:.3f} ms byte "
                 "bound" if k.startswith("K5") else ""))
    del x, want, want4
    torch.cuda.empty_cache()


def k2_small_variants(libs, dev, gen, sms) -> None:
    """The n <= 64 body as K2 runs it (trim, the NNM-shaped softmax mix):
    every variant held to the plain version, then timed in turns, at each
    of K2S_SHAPES in fp32 and bf16."""
    import torch
    from repro_torch.kernels import mixtrim_ref
    from repro_torch.kernels._common import stream_of
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name in K2S_VARIANTS:
        libs[name].variant_k2s.argtypes = [P, I, P, I, LL, I, P, I, P]
    for n, d, f in K2S_SHAPES:
        x32 = torch.randn((n, d), generator=gen, device=dev)
        m = torch.softmax(torch.randn((n, n), generator=gen, device=dev), -1)
        for dtype in (torch.float32, torch.bfloat16):
            x = x32 if dtype == torch.float32 else x32.to(dtype)
            mm = m.to(dtype).float()
            out = torch.empty(d, device=dev)
            step = 1 << 25
            want = torch.cat([mixtrim_ref(x[:, c:c + step], mm, f)
                              for c in range(0, d, step)])
            runs = {}
            for name in K2S_VARIANTS:
                def run(lib=libs[name]):
                    rc = lib.variant_k2s(x.data_ptr(), 0 if dtype == torch.float32
                                         else 1, mm.data_ptr(), n, d, f,
                                         out.data_ptr(), 16 * sms, stream_of(x))
                    assert rc == 0, rc
                    return out
                close(run(), want)
                runs[name] = run
            del want
            times = {k: [] for k in runs}
            for order in (list(runs), list(runs)[::-1]):
                for k in order:
                    times[k].append(time_ms(runs[k]))
            el = x.element_size()
            bound = 1e3 * (el * n * d + 4.0 * d) / 3.35e12
            for k, ts in times.items():
                print(f"{k} n={n} D={d} f={f} {str(dtype)[6:]} mix: "
                      f"{min(ts):.3f} ms (turns {', '.join(f'{t:.3f}' for t in ts)}), "
                      f"{100 * bound / min(ts):.0f} % of the {bound:.3f} ms byte bound",
                      flush=True)
            del x, out
        del x32, m
        torch.cuda.empty_cache()


def k2_variants(libs, dev, gen, sms) -> None:
    """K2's 64 < n <= 1024 body: committed against mix-only, in turns."""
    import torch
    from repro_torch.kernels import mixtrim_ref
    from repro_torch.kernels._common import stream_of
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name in K2_VARIANTS:
        lib = libs[name]
        lib.variant_k2.argtypes = [P, P, P, I, LL, I, P, I, P]
        lib.repro_mixtrim_select_scratch.argtypes = [I]
        lib.repro_mixtrim_select_scratch.restype = LL
    for n, d in K2_SHAPES:
        f = n // 32
        x = torch.randn((n, d), generator=gen, device=dev)
        m = torch.softmax(torch.randn((n, n), generator=gen, device=dev), -1)
        mt = torch.empty(libs["K2 committed"].repro_mixtrim_select_scratch(n),
                         device=dev)
        for tag, mm in (("mix", m), ("no-mix", None)):
            out = torch.empty(d, device=dev)
            runs = {}
            for name in K2_VARIANTS:
                def run(lib=libs[name], mm=mm):
                    rc = lib.variant_k2(x.data_ptr(),
                                        None if mm is None else mm.data_ptr(),
                                        mt.data_ptr(), n, d, f, out.data_ptr(),
                                        16 * sms, stream_of(x))
                    assert rc == 0, rc
                    return out
                runs[name] = run
            step = (1 << 28) // n
            want = torch.cat([mixtrim_ref(x[:, c:c + step], mm, f)
                              for c in range(0, d, step)])
            close(runs["K2 committed"](), want)
            times = {k: [] for k in runs}
            for _ in range(2):
                for k, fn in runs.items():
                    times[k].append(time_ms(fn))
            for k, ts in times.items():
                print(f"{k} n={n} D={d} f={f} {tag}: {min(ts):.3f} ms (turns "
                      f"{', '.join(f'{t:.3f}' for t in ts)})", flush=True)
        del x, m, mt
        torch.cuda.empty_cache()


def k1_variants(libs, dev, gen, sms) -> None:
    """K1's tiled product at TM = 128: committed against its variants, in
    turns, each held to the plain version first."""
    import torch
    from repro_torch.kernels import gram_ref
    from repro_torch.kernels._common import stream_of
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name in K1_VARIANTS:
        lib = libs[name]
        lib.repro_gram_tiled.argtypes = [P, I, I, I, LL, I, P, I, P, P]
        lib.repro_gram_tiled_chunks.argtypes = [I, I, LL, I, I]
        lib.repro_gram_tiled_scratch.argtypes = [I, I, I, I]
        lib.repro_gram_tiled_scratch.restype = LL
    d = 1 << 20
    for n in K1_NS:
        x = torch.randn((n, d), generator=gen, device=dev)
        want = gram_ref(x)
        runs = {}
        for name in K1_VARIANTS:
            lib = libs[name]
            chunks = lib.repro_gram_tiled_chunks(1, n, d, 128, sms)
            part = torch.empty(lib.repro_gram_tiled_scratch(1, n, 128, chunks),
                               device=dev)
            g = torch.empty((n, n), device=dev)

            def run(lib=lib, chunks=chunks, part=part, g=g):
                rc = lib.repro_gram_tiled(x.data_ptr(), 0, 1, n, d, 128,
                                          part.data_ptr(), chunks, g.data_ptr(),
                                          stream_of(x))
                assert rc == 0, rc
                return g
            close(run(), want)
            runs[name] = run
        times = {k: [] for k in runs}
        for order in (list(runs), list(runs)[::-1]):
            for k in order:
                times[k].append(time_ms(runs[k]))
        for k, ts in times.items():
            print(f"{k} n={n} D={d}: {min(ts):.3f} ms (turns "
                  f"{', '.join(f'{t:.3f}' for t in ts)})", flush=True)
        del x, want, runs
        torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
