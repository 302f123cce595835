#!/usr/bin/env python3
"""The launch-sized kernels from two checkouts, in turns (A B B A): host
and device microseconds per call beside the library call's, and whether
the two checkouts' outputs agree bit for bit.

    python3 scripts/torch_launch_ab.py [A_ROOT] [B_ROOT]

A_ROOT defaults to ``build/parent`` (unpack the parent commit there with
``git archive``), B_ROOT to this checkout.  Each side runs in processes of
its own that import that checkout's ``repro_torch`` (its wrappers, and its
``csrc`` built under ``<root>/build/kernels``) and this checkout's timing
helpers (``chip_smoke.time_samples`` and ``split_sample``, as phase 18d
uses them).  Both sides build first, in parallel.  Then each of the four
turns runs one process, which holds each kernel to its plain version and
times it and its library call at every shape:
* K3 lanes at the grid's (5, 17 / 9, 2842) against
  ``torch.bmm(c[:, None], x)``, K3 at the fed cohorts (10 / 12 / 17,
  2842) against ``c @ x``;
* the median lanes (with and without the mix) against
  ``torch.median(x, dim=1)`` and K4 (f = 4 a lane, with and without the
  mix) at (5, 17, 2842);
* K6 lanes (s = 3), K7 lanes (s = 2, against ``torch.bmm(bm, x)``) and K7
  + K5 (s = 2) at (5, 17, 2842) in fp32 and bf16, each side on the route
  its fleet takes: the id route with the bucket ids made beforehand (A
  before the permutation route existed), else each lane's permutation;
* K6 / K7 lanes at (8, 17, 2^24), fp32 and bf16, device time only (5
  calls a sample).
Per shape the median of REPS turn samples (CUDA events around back-to-back
calls) and split samples (host clock around the enqueues behind a busy
launch; events around those launches; for a call that waits for the card,
the host's wall clock per call and no device time: ``split_or_wall``).  The library call is timed in the
same process as the kernel, so a side's host numbers can be read against
it when the host's speed drifts between turns.  Each side's first turn
saves its outputs (the launch-sized ones whole, the (8, 17, 2^24) ones as
every 4099th column and a checksum of every word) under
``build/launch_ab/``, and the bits of A and B are compared.  Prints a line
per shape and side, the bit verdicts, the card line and a JSON line.
Needs one card.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "launch_ab"
LANES = ((5, 17, 2842), (5, 9, 2842))
SINGLE = ((10, 2842), (12, 2842), (17, 2842))
GRID = (5, 17, 2842)
BIG = (8, 17, 1 << 24)
F_GRID = 4
CALLS = 200


def _checksum(t, step: int = 1 << 26):
    """A checksum of every word of ``t`` (bit patterns, position-weighted,
    in chunks) and every 4099th column of it."""
    import torch
    w = t.contiguous().view(torch.int16 if t.element_size() == 2
                            else torch.int32).reshape(-1)
    total = 0
    for c in range(0, w.numel(), step):
        k = torch.arange(c, min(c + step, w.numel()), device=w.device)
        total += int((w[c:c + step].long() * (k % 1000003 + 1)).sum())
    return {"sum": total, "cols": t[..., ::4099].cpu()}


def split_or_wall(cs, fn, calls: int) -> tuple[float, float]:
    """chip_smoke.split_sample's (host us, device us) per call, from one
    busy launch of 4 * BUSY_CYCLES.  A call that waits for the card (the
    id route reads its bucket ids back) cannot be enqueued ahead of it:
    then the host's wall clock per call, back to back up to a
    synchronize, and no device time (NaN)."""
    import time
    import torch
    fn()
    torch.cuda.synchronize()
    s, e = (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))
    torch.cuda._sleep(4 * cs.BUSY_CYCLES)
    s.record()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host = time.perf_counter() - t0
    covered = not s.query()
    e.record()
    e.synchronize()
    if covered:
        return 1e6 * host / calls, 1e3 * s.elapsed_time(e) / calls
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return 1e6 * (time.perf_counter() - t0) / calls, float("nan")


def side(root: str, mode: str, tag: str) -> None:
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    sys.path.insert(0, str(Path(root) / "src"))
    import torch
    import repro_torch.kernels as K
    from repro_torch.kernels import _build
    from repro_torch.kernels.bucketgram import assignment_matrix
    _build.library()
    if mode == "build":
        return
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(28)
    rows, saved = {}, {}
    perm_route = hasattr(K, "bucketgram_lanes_perms")

    def timed(label, kernel, plain, library, calls=CALLS, check=True):
        got = kernel()
        got = got[0] if isinstance(got, tuple) else got
        if check:
            want = plain()
            want = want[0] if isinstance(want, tuple) else want
            err, tol = cs.max_err(got, want, ulp=got.dtype == torch.bfloat16)
            if err > tol:
                raise AssertionError(f"{label}: disagrees with its plain "
                                     f"version ({err:.3e} > {tol:.3e})")
        saved[label] = got.cpu() if got.numel() < 1 << 22 else _checksum(got)
        for key, fn in (("kernel", kernel), ("library", library)):
            if fn is None:
                continue
            turn = cs.time_samples(fn, calls)
            split = [split_or_wall(cs, fn, calls) for _ in range(cs.REPS)]
            rows[f"{label} {key}"] = {
                "turn_ms": statistics.median(turn),
                "host_us": statistics.median(h for h, _ in split),
                "device_us": statistics.median(d for _, d in split)}

    for b, n, d in LANES:
        x = torch.randn((b, n, d), generator=gen, device=dev)
        c = torch.softmax(torch.randn((b, n), generator=gen, device=dev), -1)
        timed(f"K3 lanes {(b, n, d)}", lambda: K.combine_lanes(x, c),
              lambda: K.combine_lanes_ref(x, c),
              lambda: torch.bmm(c[:, None], x))
    for n, d in SINGLE:
        x = torch.randn((n, d), generator=gen, device=dev)
        c = torch.softmax(torch.randn((n,), generator=gen, device=dev), -1)
        timed(f"K3 {(n, d)}", lambda: K.combine(x, c),
              lambda: K.combine_ref(x, c), lambda: c @ x)

    b, n, d = GRID
    x = torch.randn((b, n, d), generator=gen, device=dev)
    m = torch.softmax(torch.randn((b, n, n), generator=gen, device=dev), -1)
    fs = torch.full((b,), F_GRID, dtype=torch.int32, device=dev)
    for mm, mtag in ((m, "mix"), (None, "no mix")):
        timed(f"median lanes {mtag} {GRID}", lambda: K.mixtrim_lanes(x, mm),
              lambda: K.mixtrim_lanes_ref(x, mm),
              None if mm is not None else lambda: torch.median(x, dim=1))
        timed(f"K4 {mtag} {GRID}", lambda: K.mixtrim_dyn(x, mm, fs),
              lambda: K.mixtrim_dyn_ref(x, mm, fs), None)

    perms = torch.stack([torch.randperm(n, generator=torch.Generator()
                                        .manual_seed(k))
                         for k in range(8)]).to(dev)

    def bucket_rows(xx, pp, shape, calls, check):
        bb, nn = xx.shape[:2]
        for s, gram in ((3, True), (2, False), (2, True)):
            a = torch.div(torch.argsort(pp, dim=1), s, rounding_mode="floor")
            nb = -(-nn // s)
            kind = ("K6" if nb <= 8 else "K7 + K5") if gram else "K7"
            label = f"{kind} lanes s={s} {str(xx.dtype)[6:]} {shape}"
            if perm_route:
                kernel = (K.bucketgram_lanes_perms if gram else
                          K.bucketmeans_lanes_perms)
                fn = lambda kernel=kernel, s=s: kernel(xx, pp, s)
            else:
                kernel = K.bucketgram_lanes if gram else K.bucketmeans_lanes
                fn = lambda kernel=kernel, a=a, nb=nb: kernel(xx, a, nb)
            library = None
            if not gram and shape == GRID:
                bm = torch.stack([assignment_matrix(a[k], nb)
                                  for k in range(bb)]).to(xx.dtype)
                library = lambda bm=bm: torch.bmm(bm, xx)
            timed(label, fn, lambda a=a, nb=nb, gram=gram:
                  K.bucket_means_gram_lanes_ref(xx, a, nb, with_gram=gram),
                  library, calls, check)

    for xx in (x, x.bfloat16()):
        bucket_rows(xx, perms[:b], GRID, CALLS, True)
    del x
    xb = torch.randn(BIG, generator=gen, device=dev)
    bucket_rows(xb, perms[:BIG[0]], BIG, 5, False)
    xb = xb.bfloat16()
    torch.cuda.empty_cache()
    bucket_rows(xb, perms[:BIG[0]], BIG, 5, False)
    torch.save(saved, OUT / f"{tag}.pt")
    print(json.dumps(rows))


def run(root: str, mode: str, tag: str = "") -> subprocess.Popen:
    return subprocess.Popen([sys.executable, __file__, "--side", root, mode,
                             tag], stdout=subprocess.PIPE, text=True)


def same_bits(a, b) -> bool:
    import torch
    if isinstance(a, dict):
        return a["sum"] == b["sum"] and same_bits(a["cols"], b["cols"])
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    word = torch.int16 if a.element_size() == 2 else torch.int32
    return torch.equal(a.contiguous().view(word), b.contiguous().view(word))


def main() -> int:
    if sys.argv[1:2] == ["--side"]:
        side(sys.argv[2], sys.argv[3], sys.argv[4])
        return 0
    import torch
    if not torch.cuda.is_available():
        print("torch_launch_ab: no CUDA device", file=sys.stderr)
        return 1
    OUT.mkdir(parents=True, exist_ok=True)
    a = sys.argv[1] if len(sys.argv) > 1 else str(ROOT / "build" / "parent")
    b = sys.argv[2] if len(sys.argv) > 2 else str(ROOT)
    builds = [run(a, "build"), run(b, "build")]
    if any(p.wait() for p in builds):
        raise SystemExit("torch_launch_ab: a build failed")
    got = {"A": [], "B": []}
    for i, (name, root) in enumerate((("A", a), ("B", b), ("B", b),
                                      ("A", a))):
        p = run(root, "time", f"{name}{i}")
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
    outs_a, outs_b = torch.load(OUT / "A0.pt"), torch.load(OUT / "B1.pt")
    bits = {}
    for label, va in outs_a.items():
        vb = outs_b.get(label)
        if label.startswith("K6") or label.startswith("K7 + K5"):
            what = "means"               # the Gram may fold other columns
        else:
            what = "output"
        bits[label] = None if vb is None else same_bits(va, vb)
        print(f"bits A vs B {label} ({what}): "
              f"{'equal' if bits[label] else 'DIFFER'}", flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card)
    print(json.dumps({"launch_ab": summary, "bits_equal": bits,
                      "card": card}))
    return 0 if all(bits.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
