#!/usr/bin/env python3
"""Where the time of an optimized attack's eta search goes, on one CUDA card.

    python3 scripts/torch_opt_trace.py [--src SRC] [--attack alie_opt]
                                       [--out FILE]

Builds smollm-360m's full-width worker stack layout (n = 8, f = 2, D =
361,821,120 fp32, 11 leaves), fills the stack from a seeded normal draw
on the card, and runs the trainer's search (``attack_flat_`` with the
deployed NNM + CWTM aggregate as its closure, 12 candidates and the
chosen eta's rows) on the kernel backend:

* CUDA-event and host-clock times of the closure alone (K1 + K2 and the
  host work around them), median of 3 after a warm-up;
* the same for the whole search, twice;
* one search under ``torch.profiler``: the device time of every kernel
  and op (self), its calls, its host time, the sum of the kernels'
  device time against the search's host clock (the card's idle share),
  and the host time of the syncs.

``--src`` imports ``repro_torch`` from another checkout's ``src`` (its
kernels build into that checkout's ``build/``), so that two trees are
timed in one call in turns.  The full table goes to ``--out`` (default
``build/opt_trace.txt``); the card's name and power limit are printed
last.
"""
from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def parse() -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--attack", default="alie_opt",
                    choices=("alie_opt", "foe_opt"))
    ap.add_argument("--out", default=str(ROOT / "build" / "opt_trace.txt"))
    return ap.parse_args()


def timed(fn, sync) -> tuple:
    """(device ms by CUDA events, host ms) of one call."""
    import torch
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    sync()
    t0 = time.perf_counter()
    a.record()
    fn()
    b.record()
    sync()
    return a.elapsed_time(b), 1e3 * (time.perf_counter() - t0)


def main() -> None:
    args = parse()
    sys.path.insert(0, args.src)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    from repro_torch.configs import get_config
    from repro_torch.core.attacks import attack_flat_
    from repro_torch.core.robust import robust_aggregate
    from repro_torch.core.types import AggregatorSpec
    from repro_torch.kernels import _build
    from repro_torch.kernels import dispatch as kdispatch
    from repro_torch.models import build_model
    from repro_torch.training.trainer import stack_layout

    dev = torch.device("cuda")
    _build.library()
    n, f = 8, 2
    params = build_model(get_config("smollm-360m")).init(0, dev)
    layout = stack_layout(params, n)
    del params
    segs = [(off, size) for off, size, _ in layout.segments]
    gen = torch.Generator(device=dev).manual_seed(0)
    flat = torch.randn((n, layout.width), generator=gen, device=dev)
    spec = AggregatorSpec(rule="cwtm", f=f, pre="nnm", backend="cuda")

    def close(fl):
        return robust_aggregate(kdispatch.stack_views(fl, layout), spec)

    def search():
        internals = {}
        attack_flat_(args.attack, flat, f, segments=segs, agg_closure=close,
                     internals=internals)
        return internals

    sync = torch.cuda.synchronize
    print(f"src {args.src}: n {n}, f {f}, D {layout.width}, "
          f"{len(segs)} segments, {args.attack}")
    close(flat)
    agg = [timed(lambda: close(flat), sync) for _ in range(3)]
    print(f"closure (K1 + K2): device ms {[round(d, 3) for d, _ in agg]}, "
          f"host ms {[round(h, 3) for _, h in agg]}, median device "
          f"{statistics.median(d for d, _ in agg):.3f}")
    internals = search()
    print(f"eta {float(internals['eta'])}")
    runs = [timed(search, sync) for _ in range(2)]
    print(f"search (13 aggregates): device ms {[round(d, 3) for d, _ in runs]}"
          f", host ms {[round(h, 3) for _, h in runs]}")

    from torch.profiler import ProfilerActivity, profile
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        search()
        sync()
        wall = 1e3 * (time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated(dev) - base
    rows = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    from torch.autograd import DeviceType
    kernels = [e for e in rows if e.device_type == DeviceType.CUDA
               and e.key != "Command Buffer Full"]
    busy = sum(dev_us(e) for e in kernels) / 1e3
    syncs = sum(e.self_cpu_time_total for e in rows
                if "Synchronize" in e.key or "_local_scalar_dense" in e.key
                or "cudaMemcpy" in e.key) / 1e3
    print(f"profiled search: host {wall:.3f} ms, device busy {busy:.3f} ms "
          f"(idle share {1 - busy / wall:.3f}), host time in syncs and "
          f"copies {syncs:.3f} ms, peak above the stack "
          f"{peak / 2**30:.3f} GiB")
    table = sorted(kernels, key=dev_us, reverse=True) + sorted(
        (e for e in rows if e not in kernels), key=dev_us, reverse=True)
    lines = [f"{'op':60s} {'calls':>7s} {'dev ms':>10s} {'cpu ms':>10s}"]
    for e in table:
        lines.append(f"{e.key[:60]:60s} {e.count:7d} {dev_us(e) / 1e3:10.3f} "
                     f"{e.self_cpu_time_total / 1e3:10.3f}")
    print("\n".join(lines[:1 + min(len(kernels), 16)]))
    host = sorted(rows, key=lambda e: e.self_cpu_time_total, reverse=True)
    print("by host time:")
    for e in host[:12]:
        print(f"  {e.key[:60]:60s} {e.count:7d} "
              f"{e.self_cpu_time_total / 1e3:10.3f} ms")
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text("\n".join(lines) + "\n")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip() or smi.stderr.strip())


if __name__ == "__main__":
    main()
