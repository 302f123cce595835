#!/usr/bin/env python3
"""K3 at the launch-sized shapes from two checkouts, in turns (A B B A):
host and device microseconds per call beside the library call's.

    python3 scripts/torch_launch_ab.py [A_ROOT] [B_ROOT]

A_ROOT defaults to ``build/parent`` (unpack the parent commit there with
``git archive``), B_ROOT to this checkout.  Each side runs in processes of
its own that import that checkout's ``repro_torch`` (its wrappers, and its
``csrc`` built under ``<root>/build/kernels``) and this checkout's timing
helpers (``chip_smoke.time_samples`` and ``split_sample``, as phase 18d
uses them).  Both sides build first, in parallel.  Then each of the four
turns runs one process, which holds each kernel to its plain version and
times it and its library call at every shape: K3 lanes at the grid's (5,
17 / 9, 2842) against ``torch.bmm(c[:, None], x)``, K3 at the fed
cohorts (10 / 12 / 17, 2842) against ``c @ x``; per shape the median of
REPS turn samples (CUDA events around 200 back-to-back calls) and split
samples (host clock around 200 enqueues behind a busy launch; events
around those launches).  The library call is timed in the same process
as the kernel, so a side's host numbers can be read against it when the
host's speed drifts between turns.  Prints a line per shape and side, the
card line and a JSON line.  Needs one card.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
LANES = ((5, 17, 2842), (5, 9, 2842))
SINGLE = ((10, 2842), (12, 2842), (17, 2842))
CALLS = 200


def side(root: str, mode: str) -> None:
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    sys.path.insert(0, str(Path(root) / "src"))
    import torch
    from repro_torch.kernels import (_build, combine, combine_lanes,
                                     combine_lanes_ref, combine_ref)
    _build.library()
    if mode == "build":
        return
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(28)
    rows = {}

    def timed(label, kernel, plain, library):
        cs.agree(f"{label} vs its plain version", kernel(), plain())
        for key, fn in (("kernel", kernel), ("library", library)):
            turn = cs.time_samples(fn, CALLS)
            split = [cs.split_sample(fn, CALLS) for _ in range(cs.REPS)]
            rows[f"{label} {key}"] = {
                "turn_ms": statistics.median(turn),
                "host_us": statistics.median(h for h, _ in split),
                "device_us": statistics.median(d for _, d in split)}

    for b, n, d in LANES:
        x = torch.randn((b, n, d), generator=gen, device=dev)
        c = torch.softmax(torch.randn((b, n), generator=gen, device=dev), -1)
        timed(f"K3 lanes {(b, n, d)}", lambda: combine_lanes(x, c),
              lambda: combine_lanes_ref(x, c), lambda: torch.bmm(c[:, None], x))
    for n, d in SINGLE:
        x = torch.randn((n, d), generator=gen, device=dev)
        c = torch.softmax(torch.randn((n,), generator=gen, device=dev), -1)
        timed(f"K3 {(n, d)}", lambda: combine(x, c), lambda: combine_ref(x, c),
              lambda: c @ x)
    print(json.dumps(rows))


def run(root: str, mode: str) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, __file__, "--side", root, mode],
                            stdout=subprocess.PIPE, text=True)


def main() -> int:
    if sys.argv[1:2] == ["--side"]:
        side(sys.argv[2], sys.argv[3])
        return 0
    import torch
    if not torch.cuda.is_available():
        print("torch_launch_ab: no CUDA device", file=sys.stderr)
        return 1
    a = sys.argv[1] if len(sys.argv) > 1 else str(ROOT / "build" / "parent")
    b = sys.argv[2] if len(sys.argv) > 2 else str(ROOT)
    builds = [run(a, "build"), run(b, "build")]
    if any(p.wait() for p in builds):
        raise SystemExit("torch_launch_ab: a build failed")
    got = {"A": [], "B": []}
    for name, root in (("A", a), ("B", b), ("B", b), ("A", a)):
        p = run(root, "time")
        out, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"torch_launch_ab: side {name} failed")
        got[name].append(json.loads(out.strip().splitlines()[-1]))
    summary = {}
    for name in ("A", "B"):
        for label in got[name][0]:
            vals = {m: [t[label][m] for t in got[name]]
                    for m in ("turn_ms", "host_us", "device_us")}
            summary[f"{name} {label}"] = vals
            print(f"{name} {label}: turns {vals['turn_ms']} ms, host "
                  f"{[round(v, 1) for v in vals['host_us']]} us, device "
                  f"{[round(v, 2) for v in vals['device_us']]} us", flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card)
    print(json.dumps({"A": a, "B": b, "turns": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
