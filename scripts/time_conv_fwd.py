#!/usr/bin/env python3
"""Time the fused conv block's forward kernels of one tree on the GPU.

    python3 scripts/time_conv_fwd.py [--root DIR] [--iters 20] [--library] [--kernels]
                                     [--dtype float32|bfloat16]

Imports `desed_task_tpu_torch` from DIR (default: this repository), builds
its kernels, and prints one line per 2024 conv block, at the serving batch
(B=64) and at the train batch (B=60), ten-second clips, for `conv_bn_stats`
(row 1) and `glu_drop_pool` (row 2; no dropout at B=64, as serving runs it,
dropout bits at keep 0.5 at B=60, as the train step runs it): the card, the
tree, ms per call (CUDA events, mean of --iters after 3 warm-ups), the bound
(bytes and FLOPs counted as chip_smoke.py counts them, over the H100 SXM
peaks), the bound's share of the time and the max |kernel - plain| relative
to max(1, max |plain|); then the sums over the seven blocks. `--library`
also times F.conv2d (cuDNN, TF32 off) on the same input, the yardstick of
row 1. `--kernels` adds, per block, each CUDA kernel's device time per call
(torch.profiler over --iters calls of each wrapper). Each block's line
names the CUDA kernel its bf16 conv_bn_stats plan picks (`FWD_KERNELS`;
"n/a" in fp32 and for a tree without it). `--dtype bfloat16`
times the kernels' bf16 mode (bf16 x, w, y, Wg and z; the bound counts bf16
bytes and the products at the tensor cores' bf16 peak; F.conv2d in bf16).
Results also go to chiprun_out/time_conv_fwd.json (one entry per run).
To compare two versions of the kernels on one card, unpack each into its
own directory and run them in turns in one call (A, B, B, A):

    for d in A B B A; do python3 scripts/time_conv_fwd.py --root $d; done
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
from pathlib import Path

N_SAMPLES = 160000
PEAK_FP32_FLOPS = 67e12  # H100 SXM fp32 outside the tensor cores
PEAK_BF16_FLOPS = 989e12  # H100 SXM bf16 tensor cores, dense
PEAK_BYTES = 3.35e12  # H100 SXM HBM3


def bound_ms(n_bytes: float, flops: float, peak: float = PEAK_FP32_FLOPS) -> tuple[float, str]:
    tb, tf = n_bytes / PEAK_BYTES * 1e3, flops / peak * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--library", action="store_true")
    ap.add_argument("--kernels", action="store_true")
    ap.add_argument("--dtype", choices=("float32", "bfloat16"), default="float32")
    args = ap.parse_args()

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("time_conv_fwd: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, str(Path(args.root).resolve()))
    from desed_task_tpu_torch.ops import _build, fused_cnn
    from desed_task_tpu_torch.ops.frontend import MelConfig
    from desed_task_tpu_torch.recipes_config import crnn_2024

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True,
                          timeout=60).stdout.splitlines()[0].strip()
    _build.build_all()

    def time_ms(fn):
        for _ in range(3):
            fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / args.iters

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

    def rel(got, want):
        return max(float((a - b).abs().max()) / max(1.0, float(b.abs().max()))
                   for a, b in zip(got, want))

    cnn = crnn_2024().cnn
    gen = torch.Generator().manual_seed(0)
    dev = torch.device("cuda")
    dt = getattr(torch, args.dtype)
    es = 2 if dt == torch.bfloat16 else 4  # bytes of an activation or weight
    peak = PEAK_BF16_FLOPS if dt == torch.bfloat16 else PEAK_FP32_FLOPS
    entries = []
    for B in (64, 60):
        T, Fq, ci = MelConfig().num_frames(N_SAMPLES), MelConfig().n_mels, 1
        rows = []
        for i in range(cnn.n_blocks):
            co = getattr(cnn, f"conv{i}").weight.shape[0]
            pool = tuple(cnn.pooling[i])
            x = torch.randn(B, T, Fq, ci, generator=gen).to(dev, dt)
            w = (torch.randn(3, 3, ci, co, generator=gen) / math.sqrt(9 * ci)).to(dev, dt)
            b = (torch.randn(co, generator=gen) * 0.1).to(dev, dt)
            conv = lambda: fused_cnn.conv_bn_stats(x, w, b)
            y, _, _ = got = conv()
            err1 = rel(got, fused_cnn.conv_bn_stats_plain(x, w, b))
            M = B * T * Fq
            b1 = bound_ms(es * (x.numel() + w.numel() + co + M * co) + 4 * 2 * Fq * co,
                          2 * 9 * ci * co * M + co * M + 3 * M * co, peak)
            names = getattr(fused_cnn, "FWD_KERNELS", None)  # None in older trees
            plan = fused_cnn.conv_fwd_plan(B, T, Fq, ci, co, bf16=dt == torch.bfloat16)
            kernel = names[plan.kernel] if names and dt == torch.bfloat16 else "n/a"
            row = dict(block=i, geom=[T, Fq, ci, co], conv_ms=time_ms(conv), conv_err=err1,
                       conv_bound=b1, conv_kernel=kernel)
            if args.library:
                x_nchw = x.permute(0, 3, 1, 2)
                w_oihw = w.permute(3, 2, 0, 1).contiguous()
                row["conv2d_ms"] = time_ms(lambda: F.conv2d(x_nchw, w_oihw, b, padding=1))
            scale_f = (1.0 + 0.1 * torch.randn(Fq * co, generator=gen)).to(dev)
            bias_f = (0.1 * torch.randn(Fq * co, generator=gen)).to(dev)
            wg = (torch.randn(co, co, generator=gen) / math.sqrt(co)).to(dev, dt)
            bg = (0.1 * torch.randn(co, generator=gen)).to(dev, dt)
            bits, keep = None, 1.0
            if B == 60:
                bits = torch.randint(0, 256, (B, T, Fq * co), generator=gen,
                                     dtype=torch.uint8).to(dev)
                keep = 0.5
            glu = lambda: fused_cnn.glu_drop_pool(y, scale_f, bias_f, wg, bg, bits, pool=pool,
                                                  keep_prob=keep)
            z = glu()
            err2 = rel([z], [fused_cnn.glu_drop_pool_plain(y, scale_f, bias_f, wg, bg, bits,
                                                           pool=pool, keep_prob=keep)])
            b2 = bound_ms(es * (y.numel() + co * co + co + z.numel()) + 4 * 2 * Fq * co
                          + (0 if bits is None else bits.numel()), M * (2 * co * co + 8 * co), peak)
            row.update(glu_ms=time_ms(glu), glu_err=err2, glu_bound=b2)
            if args.kernels:
                row.update(conv_kernels=kernel_ms(conv), glu_kernels=kernel_ms(glu))
            rows.append(row)
            lib = f", F.conv2d {row['conv2d_ms']:.3f} ms" if "conv2d_ms" in row else ""
            print(f"[{card}] {args.root} {args.dtype} B={B} block {i} T={T} F={Fq} {ci}->{co}: "
                  f"conv_bn_stats ({kernel}) "
                  f"{row['conv_ms']:.3f} ms (bound {b1[0]:.3f} {b1[1]}, "
                  f"{b1[0] / row['conv_ms']:.0%}{lib}, err {err1:.2e}); glu_drop_pool "
                  f"{row['glu_ms']:.3f} ms (bound {b2[0]:.3f} {b2[1]}, "
                  f"{b2[0] / row['glu_ms']:.0%}, err {err2:.2e})", flush=True)
            for key in ("conv_kernels", "glu_kernels") if args.kernels else ():
                print("    " + "; ".join(f"{k} {v:.3f} ms" for k, v in row[key].items()),
                      flush=True)
            del x, y, z, bits, got
            T, Fq, ci = T // pool[0], Fq // pool[1], co

        tot = {k: sum(r[k] for r in rows) for k in ("conv_ms", "glu_ms")}
        tot.update(conv_bound=sum(r["conv_bound"][0] for r in rows),
                   glu_bound=sum(r["glu_bound"][0] for r in rows))
        lib = ""
        if args.library:
            tot["conv2d_ms"] = sum(r["conv2d_ms"] for r in rows)
            lib = f", F.conv2d {tot['conv2d_ms']:.3f} ms"
        print(f"[{card}] {args.root} {args.dtype} B={B} sum of 7 blocks: conv_bn_stats "
              f"{tot['conv_ms']:.3f} ms "
              f"(bound {tot['conv_bound']:.3f}{lib}); glu_drop_pool {tot['glu_ms']:.3f} ms "
              f"(bound {tot['glu_bound']:.3f})", flush=True)
        entries.append(dict(card=card, root=args.root, dtype=args.dtype, B=B, rows=rows,
                            total=tot))
    out = Path(__file__).resolve().parents[1] / "chiprun_out"
    out.mkdir(exist_ok=True)
    with open(out / "time_conv_fwd.json", "a") as fh:
        for e in entries:
            fh.write(json.dumps(e) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
