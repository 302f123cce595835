#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (src/repro_torch) on one GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. environment: torch / CUDA / nvcc versions, the card, TF32 off;
  2. build: the CUDA kernels of src/repro_torch/kernels/csrc, compiled
     from the checkout by nvcc (one process per source, in parallel);
  3. each kernel (K1 gram, K2 mixtrim, K3 combine) against its plain
     PyTorch version on the card at the main path's shape (n = 8 workers,
     D = 361,821,120: full-width smollm-360m), and at n = 17, f = 8 on a
     ragged smaller D; times by CUDA events (median of 7, after a warm-up)
     beside the least time the card could take (bound) and, where one
     PyTorch call computes the same function, that call's time;
  4. the main path: ``repro_torch.launch.train.main`` for 3 D-SHB steps of
     full-width smollm-360m, n = 8, f = 2, ALIE, NNM + CWTM; asserts finite
     loss / kappa_hat, one K1 and one K2 launch per step and no recorded
     fallback; then step 1's attacked stack through robust_aggregate on
     the kernel backend against the leaf-streamed torch backend;
  5. the gram-rule path: 2 steps with NNM + GM, asserting K3 ran;
  6. summary: the K1-K7 table, the kernels JSON line, the card line, and
     last the {"ok": true, ...} line.

It needs one CUDA card and imports nothing of JAX or of the reference
package ``repro``.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

N_MAIN, F_MAIN = 8, 2
D_MAIN = 361_821_120            # smollm-360m parameter count (tied, padded vocab)
N_SENT, F_SENT, D_SENT = 17, 8, (1 << 24) + 3
PLAIN_CHUNK = 1 << 25           # plain mixtrim runs in D-chunks (sort indices)
REPS = 7
RTOL = 1e-5                     # of the largest finite |plain| (fp32 contract)
FP32_TFLOPS = 67e12             # H100 SXM fp32 outside the tensor cores

#: Memory rate by card name (NVIDIA data sheets); the SXM part otherwise.
MEM_RATE = {"H100 PCIe": 2.0e12, "H100 NVL": 3.9e12, "H200": 4.8e12}


def log(*a):
    print(*a, flush=True)


def mem_rate(name: str) -> float:
    for key, rate in MEM_RATE.items():
        if key in name:
            return rate
    return 3.35e12


def time_ms(fn, reps: int = REPS) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def max_err(got, want) -> tuple[float, float]:
    """(max |got - want| over finite entries, tolerance); NaN / inf
    positions must agree exactly."""
    import torch
    nan_g, nan_w = torch.isnan(got), torch.isnan(want)
    if not torch.equal(nan_g, nan_w):
        raise AssertionError("NaN positions differ")
    fin = torch.isfinite(want)
    if not torch.equal(got[~fin & ~nan_w], want[~fin & ~nan_w]):
        raise AssertionError("infinities differ")
    if not bool(fin.any()):
        return 0.0, 0.0
    err = float((got[fin] - want[fin]).abs().max())
    return err, RTOL * float(want[fin].abs().max())


def bound(bytes_moved: float, flops: float, rate: float) -> tuple[float, str]:
    tb, to = 1e3 * bytes_moved / rate, 1e3 * flops / FP32_TFLOPS
    return (tb, "bytes") if tb >= to else (to, "operations")


def check(name, got, want, ms, plain_ms, bnd, library_ms=None):
    err, tol = max_err(got, want)
    ok = err <= tol
    log(f"  {name}: max_abs_err={err:.3e} tol={tol:.3e} {'OK' if ok else 'FAIL'}"
        f" | kernel {ms:.3f} ms, bound {bnd[0]:.3f} ms ({bnd[1]}), plain "
        f"{plain_ms:.3f} ms, library "
        f"{'n/a' if library_ms is None else f'{library_ms:.3f} ms'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    return err


def chunked(fn, d: int):
    """The plain mixtrim over D-chunks, concatenated."""
    import torch
    return lambda: torch.cat([fn(slice(c, min(c + PLAIN_CHUNK, d)))
                              for c in range(0, d, PLAIN_CHUNK)])


def phase_kernels(dev, rate: float) -> dict:
    import torch
    from repro_torch.core import gram as gramlib
    from repro_torch.kernels import (combine, combine_ref, gram, gram_ref,
                                     mixtrim, mixtrim_ref)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    rows = {}

    def stack(n, d, dtype=torch.float32):
        return torch.randn((n, d), generator=gen, device=dev).to(dtype)

    for n, f, d in ((N_MAIN, F_MAIN, D_MAIN), (N_SENT, F_SENT, D_SENT)):
        main = d == D_MAIN
        log(f"-- n={n} f={f} D={d} ({'main path shape' if main else 'sentinel case'})")
        x = stack(n, d)
        g = gram(x)
        gp = gram_ref(x)
        bnd = bound(4.0 * n * d + 4 * n * n, n * (n + 1) * d, rate)
        lib = time_ms(lambda: torch.mm(x, x.T)) if main else None
        ms, pms = time_ms(lambda: gram(x)), time_ms(lambda: gram_ref(x))
        err = check("K1 gram fp32", g, gp, ms, pms, bnd, lib)
        if main:
            rows["gram"] = dict(max_abs_err=err, ms=ms, plain_ms=pms,
                                bound=bnd, library_ms=lib)
            # Which fp32 sum is accurate at this D: against fp64.
            g64 = sum((xc := x[:, s:s + PLAIN_CHUNK].double()) @ xc.T
                      for s in range(0, d, PLAIN_CHUNK))
            scale = float(g64.abs().max())
            for what, val in (("kernel", g), ("plain (chunked)", gp),
                              ("one torch.mm", torch.mm(x, x.T))):
                log(f"    K1 {what} vs fp64: "
                    f"{float((val.double() - g64).abs().max()) / scale:.2e} of max|G|")
        # The main path's operands: the NNM matrix and the GM coefficients.
        m = gramlib.nnm_matrix(gramlib.pdist_sq_from_gram(gp), f)
        c = (gramlib.gm_coeff(gramlib.mixed_gram(gp, m), f) @ m).contiguous()
        for mode in ("trim", "med"):
            for mm in (m, None):
                k = 0 if mode == "med" else f
                out = mixtrim(x, mm, k, mode)
                plain = chunked(lambda s: mixtrim_ref(x[:, s], mm, k, mode), d)
                flops = (2 * n * n * d if mm is not None else 0) + n * d
                bnd = bound(4.0 * n * d + 4 * d + (4 * n * n if mm is not None else 0),
                            flops, rate)
                ms, pms = time_ms(lambda: mixtrim(x, mm, k, mode)), time_ms(plain)
                name = f"K2 mixtrim {mode} {'mix' if mm is not None else 'no-mix'} fp32"
                err = check(name, out, plain(), ms, pms, bnd)
                if main and mode == "trim" and mm is not None:
                    rows["mixtrim"] = dict(max_abs_err=err, ms=ms, plain_ms=pms,
                                           bound=bnd, library_ms=None)
        del out
        for dtype in (torch.float32, torch.bfloat16):
            xx = x if dtype == torch.float32 else x.to(dtype)
            el = xx.element_size()
            bnd = bound(1.0 * el * n * d + 4 * d + 4 * n, 2 * n * d, rate)
            lib = time_ms(lambda: c.to(dtype) @ xx) if main else None
            ms, pms = time_ms(lambda: combine(xx, c)), time_ms(lambda: combine_ref(xx, c))
            err = check(f"K3 combine {str(dtype)[6:]}", combine(xx, c),
                        combine_ref(xx, c), ms, pms, bnd, lib)
            if main and dtype == torch.float32:
                rows["combine"] = dict(max_abs_err=err, ms=ms, plain_ms=pms,
                                       bound=bnd, library_ms=lib)
            if dtype == torch.bfloat16:
                bnd = bound(1.0 * el * n * d + 4 * n * n, n * (n + 1) * d, rate)
                check("K1 gram bf16", gram(xx), gram_ref(xx),
                      time_ms(lambda: gram(xx)), time_ms(lambda: gram_ref(xx)), bnd)
                mb = m.to(dtype)
                plain = chunked(lambda s: mixtrim_ref(xx[:, s], mb, f, "trim"), d)
                bnd = bound(1.0 * el * n * d + 4 * d, 2 * n * n * d, rate)
                check("K2 mixtrim trim mix bf16", mixtrim(xx, mb, f, "trim"), plain(),
                      time_ms(lambda: mixtrim(xx, mb, f, "trim")), time_ms(plain), bnd)
            del xx
        del x, g, gp
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    return rows


def run_train(agg: str, steps: int, capture: bool):
    from repro_torch.kernels import dispatch as kdispatch
    from repro_torch.launch import train
    kdispatch.reset_launch_counts()
    out = train.main(["--arch", "smollm-360m", "--full", "--steps", str(steps),
                      "--workers", str(N_MAIN), "--byz", str(F_MAIN),
                      "--attack", "alie", "--agg", agg, "--device", "cuda"],
                     capture_first_stack=capture)
    counts = kdispatch.launch_counts()
    hist = out["history"]
    for k in ("loss", "kappa_hat", "direction_norm"):
        if not all(math.isfinite(v) for v in hist[k]):
            raise AssertionError(f"{agg}: non-finite {k}: {hist[k]}")
    rec = out["dispatch"]
    if rec is None or rec.backend != "cuda" or rec.fallbacks:
        raise AssertionError(f"{agg}: dispatch did not stay on the kernels:\n"
                             f"{rec.describe() if rec else None}")
    log(f"  {agg}: ms/step {[round(v, 1) for v in hist['ms']]}, launches "
        f"{counts}, peak {out['peak_bytes'] / 2**30:.2f} GiB")
    return out, counts


def phase_backends(out) -> None:
    """Step 1's attacked stack: kernel backend against the torch backend."""
    import torch
    from repro_torch.core.robust import robust_aggregate
    from repro_torch.core.types import AggregatorSpec
    from repro_torch.kernels import dispatch as kdispatch
    from repro_torch.tree import tree_leaves
    stack = kdispatch.stack_views(out["attacked"], out["layout"])
    got, want = (robust_aggregate(stack, AggregatorSpec(rule="cwtm", f=F_MAIN,
                                                        pre="nnm", backend=b))
                 for b in ("cuda", "torch"))
    worst = 0.0
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        err, tol = max_err(a.reshape(-1), b.reshape(-1))
        if err > tol:
            raise AssertionError(f"backends disagree: {err} > {tol}")
        worst = max(worst, err)
    log(f"  robust_aggregate cuda vs torch on step 1's attacked stack: "
        f"max_abs_err={worst:.3e} (tol {RTOL} x max|leaf|) OK")
    del got, want, stack
    torch.cuda.empty_cache()


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    from repro_torch.kernels import _build

    log("== 1. environment")
    log(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")
    nvcc = subprocess.run([_build.find_nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-1]
    log(f"nvcc: {nvcc}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"card: {card}")
    log(f"allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    rate = mem_rate(name)
    log(f"memory rate for bounds: {rate / 1e12:.2f} TB/s; fp32 peak "
        f"{FP32_TFLOPS / 1e12:.0f} TFLOP/s (data sheet)")

    log("== 2. build")
    t0 = time.perf_counter()
    _build.library()
    log(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {_build.BUILD_SECONDS:.1f} s)")
    for line in _build.BUILD_LOG.splitlines():
        if "registers" in line or "spill" in line.lower() or line.startswith("=="):
            log("  " + line.strip())

    log("== 3. kernels against their plain versions")
    rows = phase_kernels(dev, rate)

    log("== 4. main path: nnm+cwtm, 3 steps, full-width smollm-360m")
    out, counts_main = run_train("nnm+cwtm", 3, capture=True)
    if counts_main["gram"] != 3 or counts_main["mixtrim"] != 3:
        raise AssertionError(f"expected 3 K1 and 3 K2 launches: {counts_main}")
    log(out["dispatch"].describe())
    del out["state"]
    torch.cuda.empty_cache()
    phase_backends(out)
    del out
    torch.cuda.empty_cache()

    log("== 5. gram-rule path: nnm+gm, 2 steps, full depth")
    out, counts_gm = run_train("nnm+gm", 2, capture=False)
    if counts_gm["combine"] != 2 or counts_gm["gram"] != 2:
        raise AssertionError(f"expected 2 K1 and 2 K3 launches: {counts_gm}")
    del out
    torch.cuda.empty_cache()

    log("== 6. summary")
    table = [("K1", "gram", "ported, checked"), ("K2", "mixtrim", "ported, checked"),
             ("K3", "combine", "ported, checked"), ("K4", "mixtrim_dyn", "not ported"),
             ("K5", "gram_batched", "not ported"), ("K6", "bucketgram", "not ported"),
             ("K7", "bucketmeans", "not ported")]
    log("kernels: " + "; ".join(f"{k} {n}: {s}" for k, n, s in table))
    meta = {
        "gram": ("src/repro_torch/kernels/csrc/gram.cu",
                 "src/repro/kernels/gram/kernel.py:50", counts_main["gram"]),
        "mixtrim": ("src/repro_torch/kernels/csrc/mixtrim.cu",
                    "src/repro/kernels/mixtrim/kernel.py:177", counts_main["mixtrim"]),
        "combine": ("src/repro_torch/kernels/csrc/combine.cu",
                    "src/repro/kernels/combine/kernel.py:34", counts_gm["combine"]),
    }
    kernels = []
    for k, (src, rep, launches) in meta.items():
        r = rows[k]
        kernels.append({"name": k, "route": "cuda", "source": src, "replaces": rep,
                        "launches": launches, "max_abs_err": r["max_abs_err"],
                        "ms": r["ms"], "plain_ms": r["plain_ms"],
                        "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
                        "library_ms": r["library_ms"]})
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
