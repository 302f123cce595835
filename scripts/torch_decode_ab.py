#!/usr/bin/env python3
"""One arch's cached decode on one device from two checkouts, in turns
(A B B A, three times): ms per decoded token, prefill ms and kernel
launches a step, and whether the two checkouts' logits agree bit for bit.

    python3 scripts/torch_decode_ab.py [A_ROOT] [B_ROOT] [--arch A]
                                       [--layers L]

A_ROOT defaults to ``build/parent`` (unpack the parent commit there with
``git archive``), B_ROOT to this checkout.  Each turn is a process of its
own that imports that checkout's ``repro_torch`` and serves as
chip_smoke.py's phase 20 does (default: zamba2-2.7b at 24 of 54 layers,
its published widths, bf16 weights from seed 0, batch 4, prompt 64, 64
new): ``launch.serve.clocked_generate`` REPS + 1 times (the first warms
up), each timed run's median step after the first and its prefill; then
8 ``decode_step`` calls under ``torch.profiler`` for the CUDA kernels
launched a step.  Each side's first turn saves its logits under
``build/decode_ab/``; the two sides' are compared.  A pair is two
adjacent turns (A B or B A); B wins it when its median ms a token is the
lower.  Prints a line per turn, each side's median and quartiles over
all its timed runs, B's wins, the verdict, the card's name and power
limit and a JSON line.  Needs one card.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "decode_ab"
BATCH, PROMPT, NEW, PROFILED = 4, 64, 64, 8
REPS, ORDER = 3, "ABBA" * 3


def turn(root: str, arch: str, layers: int, save: str) -> dict:
    """One side's numbers, in this process."""
    sys.path.insert(0, str(Path(root) / "src"))
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import clocked_generate
    from repro_torch.models import build_model
    from repro_torch.serving import ServeEngine

    dev = torch.device("cuda")
    cfg = get_config(arch).replace(num_layers=layers, dtype=torch.bfloat16)
    model = build_model(cfg)
    params = model.init(0, dev)
    eng = ServeEngine(model, params, batch_size=BATCH,
                      max_seq=PROMPT + NEW + PROFILED)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                                (BATCH, PROMPT))
    clocked_generate(eng, prompts, NEW)
    runs = [clocked_generate(eng, prompts, NEW, keep_logits=True)
            for _ in range(REPS)]
    if save:
        torch.save({"logits": runs[0]["logits"].cpu(),
                    "tokens": torch.from_numpy(runs[0]["tokens"])}, save)
    cache, logits, _ = eng.prefill(eng.init_cache(), prompts)
    tok = torch.argmax(logits[:, -1:], dim=-1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(PROFILED):
            logits, cache = model.decode_step(params, cache, tok, PROMPT + i)
            tok = torch.argmax(logits[:, -1:], dim=-1)
        torch.cuda.synchronize()
    launches = sum(e.count for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.key != "Command Buffer Full") / PROFILED
    return {"ms": [statistics.median(r["step_ms"][1:]) for r in runs],
            "prefill_ms": [r["prefill_ms"] for r in runs],
            "launches": launches}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("a_root", nargs="?", default=str(ROOT / "build" / "parent"))
    ap.add_argument("b_root", nargs="?", default=str(ROOT))
    ap.add_argument("--arch", default="zamba2-2.7b")
    ap.add_argument("--layers", type=int, default=24)
    ap.add_argument("--turn", nargs=2, metavar=("ROOT", "SAVE"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.turn:
        res = turn(args.turn[0], args.arch, args.layers,
                   "" if args.turn[1] == "-" else args.turn[1])
        print("RESULT " + json.dumps(res), flush=True)
        return
    OUT.mkdir(parents=True, exist_ok=True)
    roots = {"A": args.a_root, "B": args.b_root}
    got: dict = {"A": [], "B": []}
    for i, side in enumerate(ORDER):
        save = str(OUT / f"{side}.pt") if i < 2 else "-"
        p = subprocess.run([sys.executable, __file__, "--arch", args.arch,
                            "--layers", str(args.layers), "--turn",
                            roots[side], save], capture_output=True,
                           text=True)
        line = [ln for ln in p.stdout.splitlines() if ln.startswith("RESULT ")]
        if p.returncode or not line:
            sys.exit(f"turn {i} ({side}) failed:\n{p.stdout[-3000:]}\n"
                     f"{p.stderr[-3000:]}")
        res = json.loads(line[0][7:])
        got[side].append(res)
        print(f"turn {i} {side} ({roots[side]}): {args.arch} {args.layers} "
              f"layers, batch {BATCH}, prompt {PROMPT}, {NEW} new: "
              f"ms per decoded token {[round(v, 3) for v in res['ms']]}, "
              f"prefill ms {[round(v, 1) for v in res['prefill_ms']]}, "
              f"{res['launches']:.0f} kernel launches a step", flush=True)
    meds = {}
    for side, rs in got.items():
        ms = sorted(v for r in rs for v in r["ms"])
        q = statistics.quantiles(ms, n=4)
        meds[side] = statistics.median(ms)
        pre = statistics.median(v for r in rs for v in r["prefill_ms"])
        print(f"{side}: ms per decoded token median {meds[side]:.3f}, "
              f"quartiles {q[0]:.3f} / {q[2]:.3f}, {len(ms)} runs; prefill "
              f"median {pre:.1f} ms")
    turns = [statistics.median(got[side][ORDER[:i].count(side)]["ms"])
             for i, side in enumerate(ORDER)]
    pairs = [(turns[i], turns[i + 1]) if ORDER[i] == "A" else
             (turns[i + 1], turns[i]) for i in range(0, len(ORDER), 2)]
    wins = sum(b < a for a, b in pairs)
    print(f"B the faster in {wins} of {len(pairs)} pairs", flush=True)
    import torch
    a, b = torch.load(OUT / "A.pt"), torch.load(OUT / "B.pt")
    diff = float((a["logits"] - b["logits"]).abs().max())
    same = bool(torch.equal(a["tokens"], b["tokens"]))
    print(f"logits max |A - B| {diff:.3e}; tokens equal: {same}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip() or smi.stderr.strip())
    summary = {side: {k: [r[k] for r in rs] for k in rs[0]}
               for side, rs in got.items()}
    print(json.dumps({"arch": args.arch, "layers": args.layers,
                      "sides": summary, "medians": meds, "b_wins": wins,
                      "pairs": len(pairs), "logits_max_abs_diff": diff,
                      "tokens_equal": same}))


if __name__ == "__main__":
    main()
