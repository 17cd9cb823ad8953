#!/usr/bin/env python3
"""Where the time of the port's serving forward goes, on one NVIDIA GPU.

    python3 scripts/profile_torch_serving.py [--dtype float32|bfloat16]

Runs the device program of desed_task_tpu_torch's InferencePipeline for the
2024 CRNN (batch 64, ten-second clips, 768x496 frame embeddings, MEDIAN_2024,
50 thresholds; seeded random weights) and prints:
  * the forward time per batch as the median and quartiles of 7 timed
    repeats of 10 calls each (CUDA events), with the card's name and power
    limit;
  * a torch.profiler trace of 3 forwards: device time by kernel and the
    device's idle share over the traced window (wall time between the first
    and last device activity, minus the summed kernel time). Where the
    profiler records no device time, it says so instead of a share.
`--dtype bfloat16` profiles the bf16 serving configuration instead
(`crnn_2024(compute_dtype=torch.bfloat16)` with `MelConfig(compute_dtype=
"bfloat16")`). The full table goes to chiprun_out/profile_torch_serving.txt
(profile_torch_serving_bf16.txt).
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
BATCH = 64


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dtype", choices=("float32", "bfloat16"), default="float32")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("profile_torch_serving: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from chip_smoke import card_line
    from desed_task_tpu_torch.inference.pipeline import InferencePipeline
    from desed_task_tpu_torch.labels.encoder import ManyHotEncoder
    from desed_task_tpu_torch.models.crnn import init_weights
    from desed_task_tpu_torch.ops.frontend import MelConfig
    from desed_task_tpu_torch.recipes_config import MEDIAN_2024, crnn_2024

    card = card_line()
    torch.backends.cudnn.allow_tf32 = False
    bf = args.dtype == "bfloat16"
    model = init_weights(crnn_2024(compute_dtype=torch.bfloat16 if bf else None),
                         torch.Generator().manual_seed(0))
    enc = ManyHotEncoder([f"c{i}" for i in range(27)], 10, 2048, 256, 4, 16000)
    pipe = InferencePipeline(model, None, enc, mel_cfg=MelConfig(compute_dtype=args.dtype),
                             median_filter=MEDIAN_2024,
                             thresholds=tuple(np.arange(1 / 100, 1, 1 / 50)),
                             batch_size=BATCH, device="cuda")
    rng = np.random.default_rng(0)
    audio = torch.as_tensor(rng.standard_normal((BATCH, 160000)).astype(np.float32) * 0.1,
                            device="cuda")
    emb = torch.as_tensor(rng.standard_normal((BATCH, 768, 496)).astype(np.float32),
                          device="cuda")

    for _ in range(3):
        pipe.forward(audio, emb)
    torch.cuda.synchronize()
    reps = []
    for _ in range(7):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(10):
            pipe.forward(audio, emb)
        end.record()
        end.synchronize()
        reps.append(start.elapsed_time(end) / 10)
    q1, med, q3 = np.percentile(reps, [25, 50, 75])
    print(f"[{card}] {args.dtype} forward per batch of {BATCH}: median {med:.3f} ms, "
          f"quartiles {q1:.3f} / {q3:.3f} ms over {len(reps)} repeats of 10 "
          f"({BATCH / med * 1e3:.1f} clips/s)", flush=True)

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            pipe.forward(audio, emb)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    table = prof.key_averages().table(sort_by="self_device_time_total", row_limit=40)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    name = "profile_torch_serving_bf16.txt" if bf else "profile_torch_serving.txt"
    (out / name).write_text(f"{card}\n{table}\n")
    if not kernels:
        print(f"[{card}] profiler recorded no device time: idle share not measured")
        return 0
    t0 = min(e.time_range.start for e in kernels)
    t1 = max(e.time_range.end for e in kernels)
    window = t1 - t0
    print(f"[{card}] traced 3 forwards: device busy {busy_us / 1e3:.3f} ms of a "
          f"{window / 1e3:.3f} ms window, idle share {1 - busy_us / window:.3f}")
    by_name: dict[str, float] = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:15]:
        print(f"  {us / 3e3:9.3f} ms/forward  {us / busy_us:6.1%}  {name[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
