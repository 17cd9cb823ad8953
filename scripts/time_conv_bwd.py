#!/usr/bin/env python3
"""Time the fused conv block's backward kernels of one tree on the GPU.

    python3 scripts/time_conv_bwd.py [--root DIR] [--iters 20] [--library] [--kernels]
                                     [--dtype bfloat16]

Imports `desed_task_tpu_torch` from DIR (default: this repository), builds
its kernels, and prints one line per 2024 conv block at the train batch
(B=60, ten-second clips) for `conv_bn_stats_bwd` (dx skipped at block 0, as
the train step does) and `glu_drop_pool_bwd` (dropout bits, keep 0.5): the
card, the tree, ms per call (CUDA events, mean of --iters after 3
warm-ups), the bound (bytes and FLOPs counted as chip_smoke.py counts them,
over the H100 SXM peaks) and the max |kernel - plain| relative to
max(1, max |plain|) under unit-scale cotangents; then the sums over the
seven blocks. `--library` also times cuDNN's fp32 conv backward (F.conv2d
autograd, TF32 off) on the same shapes, the yardstick of conv_bn_stats_bwd.
`--kernels` adds, per block, each CUDA kernel's device time per call
(torch.profiler over --iters calls of each wrapper), with the dW kernels'
(`conv_dw_*`: the tensor-core `conv_dw_taps_kernel`, the Ci = 1
`conv_dw_c1_bf16_kernel` and the fp32 ones) summed per block and over the
seven. `--dtype bfloat16` times the kernels' bf16 mode (bf16 activations,
weights and cotangents; bytes counted at 2 a value, products of bf16
values at the tensor cores' peak, row 4's products with fp32 dlin at the
fp32 peak; the error is the largest |kernel - plain| over the limit of one
bf16 step, 2^-7 |plain| + 1e-5 max |plain|; --library: cuDNN's conv
backward in bf16).
Results also go to chiprun_out/time_conv_bwd.json (one entry per run).
To compare two versions of the kernels on one card, unpack each into its
own directory and run them in turns in one call (A, B, B, A):

    for d in A B B A; do python3 scripts/time_conv_bwd.py --root $d; done
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
from pathlib import Path

B = 60  # mean_teacher_2024()
N_SAMPLES = 160000
PEAK_FP32_FLOPS = 67e12  # H100 SXM fp32 outside the tensor cores
PEAK_BF16_FLOPS = 989e12  # H100 SXM bf16 tensor cores, dense
PEAK_BYTES = 3.35e12  # H100 SXM HBM3


def bound_ms(n_bytes: float, flops: float, flops_bf16: float = 0.0) -> tuple[float, str]:
    """flops at the fp32 peak plus flops_bf16 at the bf16 tensor cores' peak."""
    tb = n_bytes / PEAK_BYTES * 1e3
    tf = (flops / PEAK_FP32_FLOPS + flops_bf16 / PEAK_BF16_FLOPS) * 1e3
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
        print("time_conv_bwd: no CUDA device", file=sys.stderr)
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

    bf = args.dtype == "bfloat16"
    dt = torch.bfloat16 if bf else torch.float32
    esize = 2 if bf else 4

    def rel(got, want):
        """fp32 outputs: max |kernel - plain| / max(1, max |plain|); bf16
        outputs: max |kernel - plain| over one bf16 step of |plain|."""
        errs = []
        for a, b in zip(got, want):
            if b is None:
                continue
            a, b, is_bf = a.float(), b.float(), b.dtype == torch.bfloat16
            lim = (2.0 ** -7 * b.abs() + 1e-5 * float(b.abs().max())) if is_bf else \
                max(1.0, float(b.abs().max()))
            errs.append(float(((a - b).abs() / lim).max()))
        return max(errs)

    cnn = crnn_2024().cnn
    T, Fq, ci = MelConfig().num_frames(N_SAMPLES), MelConfig().n_mels, 1
    gen = torch.Generator().manual_seed(0)
    dev = torch.device("cuda")
    rows = []
    for i in range(cnn.n_blocks):
        co = getattr(cnn, f"conv{i}").weight.shape[0]
        pool = tuple(cnn.pooling[i])
        need_dx = i > 0
        x = torch.randn(B, T, Fq, ci, generator=gen).to(dev, dt)
        w = (torch.randn(3, 3, ci, co, generator=gen) / math.sqrt(9 * ci)).to(dev, dt)
        y = torch.randn(B, T, Fq, co, generator=gen).to(dev, dt)
        dy = torch.randn(B, T, Fq, co, generator=gen).to(dev, dt)
        ds, dq = (torch.randn(Fq * co, generator=gen).to(dev) for _ in range(2))
        conv = lambda: fused_cnn.conv_bn_stats_bwd(x, w, y, dy, ds, dq, need_dx)
        err3 = rel(conv(), fused_cnn.conv_bn_stats_bwd_plain(x, w, y, dy, ds, dq, need_dx))
        M = B * T * Fq
        products = 2 * M * 9 * ci * co * (2 if need_dx else 1)
        b3 = bound_ms(esize * (x.numel() + 2 * y.numel() + 2 * w.numel() + co
                               + (x.numel() if need_dx else 0)) + 4 * 2 * Fq * co,
                      4 * M * co + (0 if bf else products), products if bf else 0)
        row = dict(block=i, geom=[T, Fq, ci, co], conv_ms=time_ms(conv), conv_err=err3,
                   conv_bound=b3)
        if args.library:
            x_nchw = x.permute(0, 3, 1, 2).requires_grad_(need_dx)
            w_oihw = w.permute(3, 2, 0, 1).contiguous().requires_grad_()
            bias = torch.zeros(co, device=dev, dtype=dt, requires_grad=True)
            out = F.conv2d(x_nchw, w_oihw, bias, padding=1)
            g_out = dy.permute(0, 3, 1, 2)
            lib_in = [w_oihw, bias] + ([x_nchw] if need_dx else [])
            row["cudnn_ms"] = time_ms(lambda: torch.autograd.grad(out, lib_in, g_out,
                                                                  retain_graph=True))
            del out, x_nchw
        scale_f = (1.0 + 0.1 * torch.randn(Fq * co, generator=gen)).to(dev)
        bias_f = (0.1 * torch.randn(Fq * co, generator=gen)).to(dev)
        wg = (torch.randn(co, co, generator=gen) / math.sqrt(co)).to(dev, dt)
        bg = (0.1 * torch.randn(co, generator=gen)).to(dev, dt)
        gz = torch.randn(B, T // pool[0], Fq // pool[1], co, generator=gen).to(dev, dt)
        bits = torch.randint(0, 256, (B, T, Fq * co), generator=gen, dtype=torch.uint8).to(dev)
        glu = lambda: fused_cnn.glu_drop_pool_bwd(y, scale_f, bias_f, wg, bg, bits, gz,
                                                  pool=pool, keep_prob=0.5)
        err4 = rel(glu(), fused_cnn.glu_drop_pool_bwd_plain(y, scale_f, bias_f, wg, bg, bits,
                                                           gz, pool=pool, keep_prob=0.5))
        # bf16: lin = bf16(BN(y)) Wg on the tensor cores; dlin Wg^T and
        # BN(y)^T dlin take fp32 dlin
        b4 = bound_ms(esize * (2 * y.numel() + gz.numel() + 2 * co * co + 2 * co)
                      + 4 * 4 * Fq * co + bits.numel(),
                      M * ((4 if bf else 6) * co * co + 20 * co), M * 2 * co * co if bf else 0)
        row.update(glu_ms=time_ms(glu), glu_err=err4, glu_bound=b4)
        if args.kernels:
            row.update(conv_kernels=kernel_ms(conv), glu_kernels=kernel_ms(glu))
            row["dw_ms"] = sum(v for k, v in row["conv_kernels"].items() if "conv_dw" in k)
        rows.append(row)
        lib = f", cuDNN {row['cudnn_ms']:.3f} ms" if "cudnn_ms" in row else ""
        print(f"[{card}] {args.root} {args.dtype} block {i} T={T} F={Fq} {ci}->{co}: "
              f"conv_bn_stats_bwd "
              f"{row['conv_ms']:.3f} ms (bound {b3[0]:.3f} {b3[1]}{lib}, err {err3:.2e}); "
              f"glu_drop_pool_bwd {row['glu_ms']:.3f} ms (bound {b4[0]:.3f} {b4[1]}, "
              f"err {err4:.2e})", flush=True)
        for key in ("conv_kernels", "glu_kernels") if args.kernels else ():
            print("    " + "; ".join(f"{k} {v:.3f} ms" for k, v in row[key].items()), flush=True)
        if args.kernels:
            print(f"    dW (the conv_dw_* kernels) {row['dw_ms']:.3f} ms", flush=True)
        del x, y, dy, bits
        T, Fq, ci = T // pool[0], Fq // pool[1], co

    tot = {k: sum(r[k] for r in rows) for k in ("conv_ms", "glu_ms")}
    tot.update(conv_bound=sum(r["conv_bound"][0] for r in rows),
               glu_bound=sum(r["glu_bound"][0] for r in rows))
    lib = ""
    if args.kernels:
        tot["dw_ms"] = sum(r["dw_ms"] for r in rows)
        lib = f", dW kernels {tot['dw_ms']:.3f} ms"
    if args.library:
        tot["cudnn_ms"] = sum(r["cudnn_ms"] for r in rows)
        lib += f", cuDNN {tot['cudnn_ms']:.3f} ms"
    print(f"[{card}] {args.root} {args.dtype} sum of 7 blocks: conv_bn_stats_bwd "
          f"{tot['conv_ms']:.3f} ms "
          f"(bound {tot['conv_bound']:.3f}{lib}); glu_drop_pool_bwd {tot['glu_ms']:.3f} ms "
          f"(bound {tot['glu_bound']:.3f})", flush=True)
    out = Path(__file__).resolve().parents[1] / "chiprun_out"
    out.mkdir(exist_ok=True)
    with open(out / "time_conv_bwd.json", "a") as fh:
        fh.write(json.dumps(dict(card=card, root=args.root, dtype=args.dtype, rows=rows,
                                 total=tot)) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
