#!/usr/bin/env python3
"""Time the fused log-mel kernel of one tree on the GPU, against its plain version.

    python3 scripts/time_fused_mel.py [--root DIR] [--batch 64 [60 ...]] [--iters 10]
                                      [--dtype float32|bfloat16] [--kernels]

Imports `desed_task_tpu_torch` from DIR (default: this repository), builds
its kernels, and prints one line per batch size and compute dtype (both,
unless --dtype names one): the card, the tree, the plan that
`fused_log_mel_plan` picks, ms per `fused_log_mel` call on B ten-second
clips of seeded noise (CUDA events, mean of --iters after 2 warm-ups) and
the max |kernel - plain| in dB. `--kernels` adds each CUDA kernel's device
time per call (torch.profiler over --iters calls): the steadier measure for
comparing two versions of one kernel, since it leaves out the wrapper's host
work. To compare two versions on one card, unpack each into its own
directory and run them in turns in one call (A, B, B, A):

    for d in A B B A; do python3 scripts/time_fused_mel.py --root $d --kernels; done
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--batch", type=int, nargs="+", default=[64])
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--dtype", choices=("float32", "bfloat16"))
    ap.add_argument("--kernels", action="store_true")
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
    card = card.splitlines()[0].strip()
    _build.build_all()
    plan_fn = _build.function("fused_mel", "fused_log_mel_plan", [_build.I] * 4)

    def kernel_ms(fn):
        """Device ms per call of each CUDA kernel that fn launches."""
        from torch.profiler import ProfilerActivity, profile

        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(args.iters):
                fn()
            torch.cuda.synchronize()
        return {e.key.replace("(anonymous namespace)::", "").split("(")[0]:
                e.device_time_total / 1e3 / args.iters
                for e in prof.key_averages() if e.device_time_total > 0}

    gen = torch.Generator().manual_seed(0)
    for B in args.batch:
        audio = (torch.randn(B, 160000, generator=gen) * 0.1).cuda()
        for dtype in (args.dtype,) if args.dtype else ("float32", "bfloat16"):
            cfg = MelConfig(compute_dtype=dtype)
            plan = plan_fn(cfg.n_fft, cfg.hop_length, cfg.n_mels, int(dtype == "bfloat16"))
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
            line = (f"[{card}] {args.root} B={B} {dtype} plan {plan}: "
                    f"{start.elapsed_time(end) / args.iters:.3f} ms, max err {err:.2e} dB")
            if args.kernels:
                ks = kernel_ms(lambda: fused_mel.fused_log_mel(audio, cfg))
                line += "; device " + ", ".join(f"{k} {v:.4f} ms" for k, v in sorted(ks.items()))
            print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
