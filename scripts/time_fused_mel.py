#!/usr/bin/env python3
"""Time the fused log-mel kernel of one tree on the GPU, against its plain version.

    python3 scripts/time_fused_mel.py [--root DIR] [--batch 64] [--iters 10]

Imports `desed_task_tpu_torch` from DIR (default: this repository), builds
its kernels, and prints one line per compute dtype: the card, the tree, ms
per `fused_log_mel` call on B ten-second clips of seeded noise (CUDA events,
mean of --iters after 2 warm-ups) and the max |kernel - plain| in dB. To
compare two versions of the kernel on one card, unpack each into its own
directory and run them in turns in one call (A, B, B, A):

    for d in A B B A; do python3 scripts/time_fused_mel.py --root $d; done
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("time_fused_mel: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.root).resolve()))
    from desed_task_tpu_torch.ops import _build, fused_mel
    from desed_task_tpu_torch.ops.frontend import MelConfig

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True, timeout=60).stdout
    _build.build_all()
    gen = torch.Generator().manual_seed(0)
    audio = (torch.randn(args.batch, 160000, generator=gen) * 0.1).cuda()
    for dtype in ("float32", "bfloat16"):
        cfg = MelConfig(compute_dtype=dtype)
        out = fused_mel.fused_log_mel(audio, cfg)
        err = float((out - fused_mel.fused_log_mel_plain(audio, cfg)).abs().max())
        for _ in range(2):
            fused_mel.fused_log_mel(audio, cfg)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.iters):
            fused_mel.fused_log_mel(audio, cfg)
        end.record()
        end.synchronize()
        print(f"[{card.splitlines()[0].strip()}] {args.root} B={args.batch} {dtype}: "
              f"{start.elapsed_time(end) / args.iters:.3f} ms, max err {err:.2e} dB", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
