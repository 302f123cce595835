#!/usr/bin/env python3
"""One worker's forward + backward of each family chip_smoke phase 19
drives, at full width on one CUDA card.

    python3 scripts/torch_family_passes.py [--out FILE]

For rwkv6-3b (4 of 32 layers), zamba2-2.7b (12 of 54) and whisper-base
(6 + 6 layers) at their published widths, bf16 weights from seed 0, one
worker's batch of 4 as phase 19 feeds it (seq 256; whisper 128 tokens and
1500 zero frames):

* CUDA-event and host-clock ms of ``loss`` + ``torch.autograd.grad``
  over every leaf, median of 5 after a warm-up, and the pass's peak
  memory above the weights;
* one pass under ``torch.profiler``: the device time of the kernels
  (self), their sum against the pass's host clock (the card's idle
  share during a pass) and the top ops by device time.

The tables go to ``--out`` (default ``build/family_passes.txt``); the
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
#: (arch, layers, seq) as chip_smoke's FAMILY_RUNS; per-worker batch 4.
RUNS = (("rwkv6-3b", 4, 256), ("zamba2-2.7b", 12, 256),
        ("whisper-base", 6, 128))
BATCH = 4


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=str(ROOT / "build" / "family_passes.txt"))
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.launch.train import lm_batch
    from repro_torch.models import build_model
    from repro_torch.training.trainer import to_device
    from repro_torch.tree import tree_leaves, tree_structure, tree_unflatten

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    sync = torch.cuda.synchronize
    out_lines = []

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    for arch, layers, seq in RUNS:
        cfg = get_config(arch).replace(num_layers=layers)
        model = build_model(cfg)
        params = model.init(0, dev)
        leaves = tree_leaves(params)
        skeleton = tree_structure(params)
        rng = np.random.default_rng(0)
        rows = rng.integers(0, cfg.vocab_size, (1, BATCH, seq + 1))
        batch = to_device(lm_batch(rows, cfg, seq), dev)
        wbatch = {k: v[0] for k, v in batch.items()}

        def one_pass():
            req = [leaf.detach().requires_grad_(True) for leaf in leaves]
            loss, _ = model.loss(tree_unflatten(skeleton, req), wbatch)
            return torch.autograd.grad(loss, req)

        one_pass()
        sync()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        dms, hms = [], []
        for _ in range(5):
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            sync()
            t0 = time.perf_counter()
            a.record()
            one_pass()
            b.record()
            sync()
            dms.append(a.elapsed_time(b))
            hms.append(1e3 * (time.perf_counter() - t0))
        peak = torch.cuda.max_memory_allocated(dev) - base
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            one_pass()
            sync()
            wall = 1e3 * (time.perf_counter() - t0)
        ops = prof.key_averages()
        kernels = [e for e in ops if e.device_type == DeviceType.CUDA
                   and e.key != "Command Buffer Full"]
        busy = sum(dev_us(e) for e in kernels) / 1e3
        launches = sum(e.count for e in kernels)
        print(f"{arch} ({layers} layers, batch {BATCH} x {seq}): one worker's "
              f"loss + grad: device ms {statistics.median(dms):.3f}, host ms "
              f"{statistics.median(hms):.3f} (median of 5; all "
              f"{[round(v, 3) for v in dms]}), peak above the weights "
              f"{peak / 2**30:.3f} GiB; profiled pass: host {wall:.3f} ms, "
              f"kernels busy {busy:.3f} ms (idle share {1 - busy / wall:.3f}), "
              f"{launches} kernel launches", flush=True)
        table = sorted(kernels, key=dev_us, reverse=True)
        lines = [f"== {arch}", f"{'kernel':70s} {'calls':>7s} {'dev ms':>10s}"]
        for e in table:
            lines.append(f"{e.key[:70]:70s} {e.count:7d} {dev_us(e) / 1e3:10.3f}")
        print("\n".join(lines[:10]), flush=True)
        out_lines += lines
        del params, leaves, batch, wbatch, prof
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
