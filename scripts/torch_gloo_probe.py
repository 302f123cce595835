#!/usr/bin/env python3
"""Which collectives gloo carries for CUDA tensors, between ranks that
share one card, and at what rate.

    python3 scripts/torch_gloo_probe.py [--mb 64,512]

Spawns 2 processes on cuda:0 joined over gloo (``repro_torch.launch.mesh.
spawn_world``) and tries, on CUDA tensors as they are: all_reduce (sum,
min, max), broadcast, all_gather_into_tensor, all_to_all_single,
reduce_scatter_tensor.  Then, for an fp32 tensor of each --mb size, times
all_reduce on the card, and all_to_all_single / all_gather_into_tensor
both on the CUDA tensor as it is and through a host copy each way: host
clock around each call after a barrier, median / min / max of 5 after a
warm-up.  Prints one JSON line per rank.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def _probe(rank: int, world: int, sizes: tuple) -> dict:
    import torch
    import torch.distributed as dist
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    out = {"rank": rank, "ok": {}, "errors": {}, "ms": {}}

    def attempt(name, fn):
        try:
            fn()
            torch.cuda.synchronize()
            out["ok"][name] = True
        except Exception as e:                   # noqa: BLE001 - reported
            out["ok"][name] = False
            out["errors"][name] = f"{type(e).__name__}: {str(e)[:160]}"

    x = torch.full((8,), float(rank + 1), device=dev)

    def ar(op):
        t = x.clone()
        dist.all_reduce(t, op=op)
        want = {dist.ReduceOp.SUM: 3.0, dist.ReduceOp.MIN: 1.0,
                dist.ReduceOp.MAX: 2.0}[op]
        assert bool((t == want).all()), t

    attempt("all_reduce_sum", lambda: ar(dist.ReduceOp.SUM))
    attempt("all_reduce_min", lambda: ar(dist.ReduceOp.MIN))
    attempt("all_reduce_max", lambda: ar(dist.ReduceOp.MAX))

    def bc():
        t = x.clone()
        dist.broadcast(t, src=1)
        assert bool((t == 2.0).all()), t
    attempt("broadcast", bc)

    def ag():
        o = torch.empty(16, device=dev)
        dist.all_gather_into_tensor(o, x)
        assert bool((o[:8] == 1).all() and (o[8:] == 2).all()), o
    attempt("all_gather_into_tensor", ag)

    def a2a():
        o = torch.empty(8, device=dev)
        dist.all_to_all_single(o, x)
        assert bool((o[:4] == 1).all() and (o[4:] == 2).all()), o
    attempt("all_to_all_single", a2a)

    def rs():
        o = torch.empty(4, device=dev)
        dist.reduce_scatter_tensor(o, x)
        assert bool((o == 3).all()), o
    attempt("reduce_scatter_tensor", rs)

    for mb in sizes:
        n = mb * (1 << 20) // 4
        big = torch.ones(n, device=dev)
        for name, fn in (
                ("all_reduce_cuda", lambda: dist.all_reduce(big)),
                ("all_to_all_cuda", lambda: _a2a(big)),
                ("all_to_all_host", lambda: _a2a(big, host=True)),
                ("all_gather_cuda", lambda: _ag(big)),
                ("all_gather_host", lambda: _ag(big, host=True))):
            fn()
            torch.cuda.synchronize()
            ms = []
            for _ in range(REPS):
                dist.barrier()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                ms.append(1e3 * (time.perf_counter() - t0))
            ms.sort()
            out["ms"][f"{name}/{mb}MiB"] = {
                "median": ms[len(ms) // 2], "min": ms[0], "max": ms[-1],
                "gbps": n * 4 / (ms[len(ms) // 2] / 1e3) / 1e9}
        del big
    return out


#: Timed calls of each collective at each size (after one warm-up).
REPS = 5


def _a2a(t, host: bool = False):
    """all_to_all_single of ``t``: on the CUDA tensor as it is, or through
    an explicit host copy each way."""
    import torch.distributed as dist
    src = t.cpu() if host else t
    o = src.new_empty(src.shape)
    dist.all_to_all_single(o, src)
    return o.to(t.device)


def _ag(t, host: bool = False):
    """all_gather_into_tensor of ``t`` (2 ranks), direct or via the host."""
    import torch.distributed as dist
    src = t.cpu() if host else t
    o = src.new_empty((2 * src.shape[0],))
    dist.all_gather_into_tensor(o, src)
    return o.to(t.device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mb", default="64,512",
                    help="comma-separated tensor sizes in MiB")
    args = ap.parse_args(argv)
    import subprocess
    import torch
    if not torch.cuda.is_available():
        print("torch_gloo_probe: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.launch.mesh import spawn_world
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; card: {card}")
    t0 = time.perf_counter()
    for row in spawn_world(
            _probe, 2, (tuple(int(m) for m in args.mb.split(",")),),
            limit=600):
        print(json.dumps(row))
    print(f"world of 2 in {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
