#!/usr/bin/env python3
"""Where a cached decode step's time goes, for each arch chip_smoke phase 20
serves, at full width on one CUDA card.

    python3 scripts/torch_decode_trace.py [--out FILE] [--arch A ...]

Each arch at phase 20's depth and batch (bf16 weights from seed 0, a
16-token prefill first), then 8 decode steps of ``decode_step`` + argmax:

* host ms per step (a synchronize after each), median of the 8;
* the same 8 steps under ``torch.profiler``: kernel launches per step,
  the kernels' device time per step, the card's idle share of the
  unprofiled step (1 - device time / host ms) and the top kernels by
  device time.

The tables go to ``--out`` (default ``build/decode_trace.txt``); the
card's name and power limit are printed last.
"""
from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
#: (arch, layers, batch) as chip_smoke's SERVE_RUNS.
RUNS = (("smollm-360m", 32, 4), ("qwen2-7b", 28, 8), ("minitron-8b", 32, 4),
        ("mixtral-8x22b", 4, 4), ("arctic-480b", 1, 4),
        ("internvl2-2b", 24, 4), ("rwkv6-3b", 32, 4),
        ("zamba2-2.7b", 54, 4), ("whisper-base", 6, 4))
PREFILL, STEPS = 16, 8


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=str(ROOT / "build" / "decode_trace.txt"))
    ap.add_argument("--arch", nargs="*", default=[r[0] for r in RUNS])
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    sync = torch.cuda.synchronize
    out_lines = []

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    for arch, layers, batch in RUNS:
        if arch not in args.arch:
            continue
        cfg = get_config(arch).replace(num_layers=layers)
        model = build_model(cfg)
        params = model.init(0, dev)
        max_seq = PREFILL + 3 * STEPS
        if cfg.family == "encdec":
            gen = torch.Generator(device=dev).manual_seed(0)
            frames = torch.randn((batch, cfg.encoder_seq, cfg.d_model),
                                 generator=gen, device=dev)
            cache = model.prefill_cache(params, frames, batch, max_seq)
        else:
            cache = model.init_cache(batch, max_seq, dev)
        rng = np.random.default_rng(0)
        tok = torch.as_tensor(rng.integers(0, cfg.vocab_size, (batch, 1)),
                              device=dev)
        pos = 0

        def step():
            nonlocal tok, cache, pos
            logits, cache = model.decode_step(params, cache, tok, pos)
            tok = torch.argmax(logits[:, -1:], dim=-1)
            pos += 1

        for _ in range(PREFILL):
            step()
        sync()
        hms = []
        for _ in range(STEPS):
            t0 = time.perf_counter()
            step()
            sync()
            hms.append(1e3 * (time.perf_counter() - t0))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            sync()
            t0 = time.perf_counter()
            for _ in range(STEPS):
                step()
            sync()
            wall = 1e3 * (time.perf_counter() - t0) / STEPS
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.key != "Command Buffer Full"]
        busy = sum(dev_us(e) for e in kernels) / 1e3 / STEPS
        launches = sum(e.count for e in kernels) / STEPS
        host = statistics.median(hms)
        print(f"{arch} ({layers} layers, batch {batch}): host ms per step "
              f"{host:.3f} (median of {STEPS}; all "
              f"{[round(v, 3) for v in hms]}); profiled: {wall:.3f} ms a "
              f"step, {launches:.0f} kernel launches a step "
              f"({launches / layers:.1f} a layer), kernels busy "
              f"{busy:.3f} ms a step: idle share {1 - busy / host:.3f} of "
              f"the unprofiled step", flush=True)
        table = sorted(kernels, key=dev_us, reverse=True)
        lines = [f"== {arch}", f"{'kernel':70s} {'calls':>7s} {'dev ms':>10s}"]
        for e in table:
            lines.append(f"{e.key[:70]:70s} {e.count:7d} {dev_us(e) / 1e3:10.3f}")
        print("\n".join(lines[:8]), flush=True)
        out_lines += lines
        del params, cache, prof, model
        torch.cuda.empty_cache()

    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text("\n".join(out_lines) + "\n")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip() or smi.stderr.strip())


if __name__ == "__main__":
    main()
