#!/usr/bin/env python3
"""Start the PyTorch port on one NVIDIA GPU and hold it to its plain versions.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):
  1. the card's name and power limit (nvidia-smi);
  2. build every CUDA kernel of the port from desed_task_tpu_torch/csrc;
  3. each kernel against its plain PyTorch version at the shapes of the 2024
     serving path (B=64): conv_bn_stats and glu_drop_pool at all seven conv
     block geometries and at a 256-channel block (WIDE_GEOM; glu_drop_pool
     with and without dropout bits; y, s, q and z bitwise equal on a rerun),
     bigru at T=156, H=192 (its plan must be "cluster"; bitwise-equal
     rerun);
  3b. the bf16 modes of conv_bn_stats and glu_drop_pool (eval and with
     bits) at the seven block geometries and at the 256-channel block
     (WIDE_GEOM; not in the sums; glu_drop_pool's ring kernel there, its
     register kernel at the seven blocks; conv_bn_stats' persistent kernels,
     conv_c1_bf16_kernel at block 0 and conv3x3_bf16_fwd_kernel at the rest
     and at WIDE_GEOM, required; each line naming the kernel its plan
     picks, then row 1b's seven-block sum) (B=64) against their plain
     versions in bf16: y and z within one bf16 step (2^-7 |plain|, above a
     floor of 1e-5 max |plain| for fp32 sums that cancel), at most 1 % of
     their elements differing, s and q within TOL_KERNEL, bitwise reruns;
     ms, bound (bf16 bytes, products at the tensor cores' peak), plain ms
     and F.conv2d in bf16 beside the fp32 rows;
  4. serving: ~130 ten-second wavs through InferencePipeline(crnn_2024())
     with seeded random weights and random 768x496 frame embeddings, the
     launch counts of the run (7, 7 and 1 per batch), and the scores against
     the same forward built from the plain versions on the card;
  4b. bf16 serving: the same wavs through InferencePipeline(crnn_2024(
     compute_dtype=torch.bfloat16), mel_cfg=MelConfig(compute_dtype=
     "bfloat16")), launches conv_bn_stats.bf16 7, glu_drop_pool.bf16 7 and
     bigru 1 per batch, finite scores; on 8 clips, from the same bf16
     features, the conv stack's output (mean |diff|) and the scores (max
     |diff|) nearer the same bf16 CRNN through the plain versions on the
     CPU than the card's fp32 forward (BF16_NEARER says why no finer
     share);
  5. timings (CUDA events): the device forward per batch, each kernel beside
     its bound, its plain version and the library call, where one exists;
  5b. the bf16 device forward per batch and its stages beside the fp32 ones;
  6. each backward kernel against its plain version at the shapes of the
     2024 train step (B=60): conv_bn_stats_bwd and glu_drop_pool_bwd at all
     seven block geometries (glu_drop_pool_bwd with and without dropout
     bits), unit-scale cotangents, bitwise-equal reruns, each block's ms,
     bound, plain ms and (row 3) cuDNN's conv backward printed; bigru_bwd at
     T=156, H=192 (plan "cluster", bitwise-equal rerun); then the BiGRU's
     stream path once, forward and backward at H=512, against the plain
     versions; then glu_drop_pool_bwd at the 256-channel block (WIDE_GEOM,
     B=60, the wide kernel; not in the sums), unit-scale cotangents, bitwise
     rerun;
  6b. the bf16 modes of conv_bn_stats_bwd and glu_drop_pool_bwd at the seven
     block geometries (B=60, bf16 unit-scale cotangents, dropout bits)
     against their bf16 plain versions: dx, dy, dw, dbias, dwg and dbg
     within one bf16 step (as phase 3b), dscale_f and dbias_f within
     TOL_KERNEL, bitwise reruns; each block's ms, bound, plain ms and
     cuDNN's bf16 conv backward beside row 3, then row 3's seven-block sum
     beside cuDNN's from the same call; the CUDA kernel each block's bf16
     GLU backward plan picks (glu_bwd_frag_kernel, required at all seven)
     and row 4b's seven-block sum; glu_drop_pool_bwd in bf16 also at the
     256-channel block (the wide kernel, glu_bwd_kernel);
  7. training: the 2024 mean-teacher step (crnn_2024() student and teacher
     at full width from a seed, mean_teacher_2024(), 60 ten-second clips with
     768x496 embeddings): the launch counts of one step (14/14/2 forward,
     7/7/1 backward), its metrics and every gradient against the same step
     built from the plain versions with the same weights and generator seed,
     bitwise-equal gradients on a rerun from the same state, finite losses
     over a few more steps;
  8. timings: ms per train step and clips/s, the plain step, and each
     backward kernel beside its bound, its plain version and the cuDNN
     backward (F.conv2d autograd, torch.nn.GRU);
  8b. the bf16 train step of bench.py (crnn_2024(compute_dtype=bf16),
     MelConfig(compute_dtype="bfloat16")) at full width on 60 clips: the
     launches of one step (conv_bn_stats.bf16 and glu_drop_pool.bf16 14,
     bigru 2, conv_bn_stats_bwd.bf16 and glu_drop_pool_bwd.bf16 7,
     bigru_bwd 1, no fp32 conv-block launch), finite metrics over 4 steps,
     bitwise-equal gradients on a rerun; then, without the random parts and
     on BF16_CPU_SLOTS clips, every conv-stack gradient (the conv biases
     aside) nearer the same bf16 step through the plain versions on the CPU
     than the CPU's fp32 step is (mean |diff|, each share printed); its ms,
     clips/s and peak memory beside the fp32 step's;
  9. front-end: the fused log-mel entry point `fused_log_mel` on 64 ten-
     second clips (one launch), then at B=64 and B=60, fp32 and bf16: the
     kernel against its plain version and against the GEMM front-end
     (`log_mel_spectrogram`, same compute dtype), bitwise-equal reruns, one
     launch per call, the plan that `fused_log_mel_plan` picks (the wgmma
     kernel, plan 3, required in bf16); the serving scores from
     `fused_log_mel` features against `pipe.forward`; timings of the kernel,
     its plain version and the GEMM front-end (the yardstick: no single
     PyTorch call computes this function);
  10. the eval path (training/evaluate.py): crnn_2024() student and teacher
     from a seed, EVAL_CLIPS seeded ten-second clips with 768x496 embeddings
     in a DeviceEvalCache of batches of EVAL_BATCH, seeded DESED ground
     truth as column tables; one SEDValidator pass (weak and synth sets from
     the cache, student and teacher, MEDIAN_2024, the intersection
     objective, a 50-point PSDS1 trajectory) and run_test at 50
     thresholds: launches 7/7/1 per batch per model pass; the same on the
     plain model (no launch); the median-filtered scores within TOL_SCORES
     of the plain model's, events at 0.5 differing only at frames within
     TOL_SCORES of 0.5 (counted), raw and weak scores within TOL_SCORES,
     the cache's scores equal to the host-dataset branch's; every metric
     finite and in [0, 1]; run_test on crnn_2024(compute_dtype=bf16) with
     the bf16 front-end (launches conv_bn_stats.bf16 and glu_drop_pool.bf16
     7, bigru 1 per batch; its scores on N_CPU_CLIPS clips nearer the plain
     bf16 CRNN on the CPU than the fp32 run's, as phase 4b); no host
     synchronisation inside the cache's loop; the forward's clips/s and the
     wall time of a validator pass and of run_test.
Then a `kernels` JSON line (rows 5 and 6 with their plan, cluster size C,
batch rows BT and us per recurrence step; the bf16 modes of rows 1 and 2 as
entries of their own, launches from the bf16 serving run, and of rows 3 and
4, launches from the bf16 train step; `launches_by_path` with each path's
counts, "eval" and "eval_bf16" among them; row 7 in fp32 and, as
`fused_log_mel.bf16`, in bf16, each at B=64 with its plan, launched on no
path), the nvidia-smi line, and the result
line {"ok": true, "device": {...}} last.

Exits non-zero, printing no result, without a CUDA device or without the
package beside this file. Details go to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
BATCH = 64
N_CLIPS = 2 * BATCH + 2  # two full batches and a partial one
PEAK_FP32_FLOPS = 67e12  # H100 SXM fp32 outside the tensor cores
PEAK_BF16_FLOPS = 989e12  # H100 SXM bf16 tensor cores, dense
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
TOL_KERNEL = 1e-4  # max |kernel - plain| / max(1, max |plain|), fp32 sums
TOL_SCORES = 1e-4  # max |kernel forward - plain forward| on sigmoid scores
TRAIN_BATCH = 60  # mean_teacher_2024(): slots [12, 6, 6, 12, 24]
EVAL_BATCH = 24  # batch_size_val of the 2024 recipe (confs/pretrained.yaml:12)
EVAL_CLIPS = 4 * EVAL_BATCH
# train step, kernels against plain versions: losses relative; each gradient
# max |kernel - plain| / max(max |plain|, 1e-3) (the conv biases' exact
# gradient is 0 under train-mode BatchNorm: both sides give fp32 noise)
TOL_LOSS = 1e-4
TOL_GRAD = 2e-3
# fused log-mel in bf16 (dB, absolute): against its plain version a
# magnitude can round one bf16 step (2^-7 relative) the other way; against
# the GEMM front-end, which keeps magnitudes and filterbank in fp32, each is
# rounded by at most 2^-8. A mel band is a positive weighted sum, so it
# moves by at most 2^-7 + 2^-16 relative: 0.0683 dB.
TOL_MEL_BF16_DB = 0.07
TOL_MEL_FP32_DB = 1e-3  # fused against the GEMM front-end, fp32 (dB)
# (T, F, Ci, Co, pool) of a block wider than 128 channels: the forward
# kernels' second channel tile (phase 3) and the GLU backward's wide kernel
# (phase 6); not in the sums
WIDE_GEOM = (156, 8, 128, 256, (1, 2))
# bf16 kernels against their plain versions (y, z, dx, dy, dw, dbias, dwg,
# dbg): one bf16 step, 2^-7 of |plain|, above a floor for fp32 sums that
# cancel (1e-5 of max |plain|); at most 1 % of the elements differ (or one,
# in a per-channel sum of fewer than 100: bf16_check)
BF16_STEP, BF16_FLOOR, BF16_FRAC = 2.0 ** -7, 1e-5, 0.01
# bf16 serving against the same bf16 CRNN through the plain versions on the
# CPU, from the same features: the conv stack's output (mean |diff|) and
# the scores (max |diff|) nearer the CPU's bf16 forward than the fp32
# forward. Not nearer by a finer share: a rounding to bf16 that flips
# because an fp32 sum ran in another order (as the kernels' do, phase 3b)
# carries through the next blocks' products, so the order alone leaves the
# two bf16 forwards about as far apart as a share of 0.4 to 0.5 of the
# bf16-vs-fp32 gap (on the CPU, fp32 conv sums moved by 6e-7 relative left
# 67 % of the conv stack's output bitwise equal and its mean |diff| at 0.40
# of that gap; inputs moved by 1e-7 moved the scores by 0.40 of it). The
# rounding points themselves are held per kernel in phase 3b and against
# JAX in tests/test_torch_crnn_bf16.py.
BF16_NEARER = 1.0
N_CPU_CLIPS = 8
# the bf16 train step against the same step through the plain versions on
# the CPU (phase 8b): the slots of mean_teacher_2024() cut to 10 clips, so
# that the CPU's bf16 and fp32 steps take seconds; full width and depth, no
# dropout, dropstep or mixup (the CPU's generator draws other numbers). Each
# conv-stack gradient's mean |card - CPU bf16| below BF16_NEARER of its mean
# |CPU fp32 - CPU bf16| (bf16-valued gradients: a rounding that flips
# because an fp32 sum ran in another order moves an entry by a whole bf16
# step, so the largest entry is no finer measure)
BF16_CPU_SLOTS = (2, 1, 1, 2, 4)
# the fused log-mel's kernels by plan (csrc/fused_mel.cu fused_log_mel_plan)
MEL_KERNELS = {1: "fused_log_mel_kernel", 3: "fused_log_mel_wg_kernel"}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(n_bytes: float, flops: float, peak_flops: float = PEAK_FP32_FLOPS
             ) -> tuple[float, str]:
    tb, tf = n_bytes / PEAK_BYTES * 1e3, flops / peak_flops * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def rel_err(a, b) -> float:
    return float((a - b).abs().max()) / max(1.0, float(b.abs().max()))


def bf16_check(a, b, sums: bool = False) -> tuple[bool, float, float]:
    """(within one bf16 step above the floor, with at most BF16_FRAC of the
    elements differing, max |a - b| / the elementwise limit, share of
    elements that differ) of bf16 a against plain b. sums: a per-channel
    sum (dbias, dbg: Co entries), whose fp32 total runs in another order and
    can round the other way: one element may differ where that is more than
    BF16_FRAC of them."""
    a, b = a.float(), b.float()
    d = (a - b).abs()
    lim = BF16_STEP * b.abs() + BF16_FLOOR * float(b.abs().max())
    worst = float((d / lim).max())
    frac = float((a != b).float().mean())
    allowed = max(BF16_FRAC, 1.0 / a.numel()) if sums else BF16_FRAC
    return worst <= 1.0 and frac <= allowed, worst, frac


def block_geometries(model, mel_cfg, n_samples: int):
    """(T, F, Ci, Co, pool) of each fused block, from the model's config."""
    cnn = model.cnn
    T, F, ci = mel_cfg.num_frames(n_samples), mel_cfg.n_mels, 1
    out = []
    for i in range(cnn.n_blocks):
        co = getattr(cnn, f"conv{i}").weight.shape[0]
        pt, pf = cnn.pooling[i]
        out.append((T, F, ci, co, (pt, pf)))
        T, F, ci = T // pt, F // pf, co
    return out


def randomize(model, gen):
    """Seeded weights with non-trivial BatchNorm statistics and biases."""
    import torch

    from desed_task_tpu_torch.models.cnn import BatchNorm
    from desed_task_tpu_torch.models.crnn import init_weights

    init_weights(model, gen)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                n = m.weight.shape[0]
                m.running_mean.copy_(torch.randn(n, generator=gen) * 0.1)
                m.running_var.copy_(1.0 + torch.rand(n, generator=gen) * 0.5)
                m.weight.copy_(1.0 + torch.randn(n, generator=gen) * 0.1)
        for name, p in model.named_parameters():
            if name.endswith("bias") and "batchnorm" not in name:
                p.copy_(torch.randn(p.shape, generator=gen) * 0.05)
    return model


def check_kernels(geoms, gen, report):
    """Phase 3: every kernel against its plain version; returns timing rows."""
    import torch
    import torch.nn.functional as F

    from desed_task_tpu_torch.ops import fused_cnn, gru

    dev = torch.device("cuda")
    rows = {"conv_bn_stats": [], "glu_drop_pool": [], "bigru": []}
    wide = {"conv_bn_stats": [], "glu_drop_pool": []}
    for gi, (T, Fq, ci, co, pool) in enumerate(list(geoms) + [WIDE_GEOM]):
        out = rows if gi < len(geoms) else wide
        B = BATCH
        x = torch.randn(B, T, Fq, ci, generator=gen).to(dev)
        w = (torch.randn(3, 3, ci, co, generator=gen) / math.sqrt(9 * ci)).to(dev)
        b = (torch.randn(co, generator=gen) * 0.1).to(dev)
        y, s, q = fused_cnn.conv_bn_stats(x, w, b)
        yp, sp, qp = fused_cnn.conv_bn_stats_plain(x, w, b)
        err = max(rel_err(y, yp), rel_err(s, sp), rel_err(q, qp))
        again = fused_cnn.conv_bn_stats(x, w, b)
        same = all(torch.equal(u, v) for u, v in zip((y, s, q), again))
        print(f"conv_bn_stats  T={T:3d} F={Fq:3d} {ci:3d}->{co:3d}: "
              f"max err {err:.3e} (tol {TOL_KERNEL}); rerun bitwise equal: {same}", flush=True)
        require(err <= TOL_KERNEL, "conv_bn_stats disagrees with its plain version")
        require(same, "conv_bn_stats is not bitwise repeatable")
        M = B * T * Fq
        conv_bytes = 4 * (x.numel() + w.numel() + co + M * co + 2 * Fq * co)
        conv_flops = 2 * 9 * ci * co * M + co * M + 3 * M * co
        x_nchw = x.permute(0, 3, 1, 2)  # channels-last view of the same input
        w_oihw = w.permute(3, 2, 0, 1).contiguous()
        out["conv_bn_stats"].append(dict(
            geom=[T, Fq, ci, co], max_abs_err=float((y - yp).abs().max()), rel_err=err,
            ms=time_ms(lambda: fused_cnn.conv_bn_stats(x, w, b)),
            plain_ms=time_ms(lambda: fused_cnn.conv_bn_stats_plain(x, w, b)),
            library_ms=time_ms(lambda: F.conv2d(x_nchw, w_oihw, b, padding=1)),
            bound=bound_ms(conv_bytes, conv_flops)))

        scale_f = (1.0 + 0.1 * torch.randn(Fq * co, generator=gen)).to(dev)
        bias_f = (0.1 * torch.randn(Fq * co, generator=gen)).to(dev)
        wg = (torch.randn(co, co, generator=gen) / math.sqrt(co)).to(dev)
        bg = (0.1 * torch.randn(co, generator=gen)).to(dev)
        bits = torch.randint(0, 256, (B, T, Fq * co), generator=gen,
                             dtype=torch.uint8).to(dev)
        errs, abs_errs = [], []
        for label, bb, keep in (("eval", None, 1.0), ("bits", bits, 0.5)):
            z = fused_cnn.glu_drop_pool(y, scale_f, bias_f, wg, bg, bb, pool=pool, keep_prob=keep)
            zp = fused_cnn.glu_drop_pool_plain(y, scale_f, bias_f, wg, bg, bb,
                                               pool=pool, keep_prob=keep)
            errs.append(rel_err(z, zp))
            abs_errs.append(float((z - zp).abs().max()))
            same = torch.equal(z, fused_cnn.glu_drop_pool(y, scale_f, bias_f, wg, bg, bb,
                                                          pool=pool, keep_prob=keep))
            print(f"glu_drop_pool  T={T:3d} F={Fq:3d} Co={co:3d} pool={pool} {label}: "
                  f"max err {errs[-1]:.3e} (tol {TOL_KERNEL}); rerun bitwise equal: {same}",
                  flush=True)
            require(errs[-1] <= TOL_KERNEL, "glu_drop_pool disagrees with its plain version")
            require(same, "glu_drop_pool is not bitwise repeatable")
        P = B * T * Fq
        glu_bytes = 4 * (y.numel() + 2 * Fq * co + co * co + co + z.numel())
        glu_flops = P * (2 * co * co + 8 * co)
        out["glu_drop_pool"].append(dict(
            geom=[T, Fq, co, *pool], max_abs_err=max(abs_errs), rel_err=max(errs),
            ms=time_ms(lambda: fused_cnn.glu_drop_pool(y, scale_f, bias_f, wg, bg, None, pool=pool)),
            plain_ms=time_ms(lambda: fused_cnn.glu_drop_pool_plain(
                y, scale_f, bias_f, wg, bg, None, pool=pool)),
            library_ms=None, bound=bound_ms(glu_bytes, glu_flops)))
        del x, y, yp, z, zp, bits, again

    T, H, IN = geoms[-1][0], 192, 128
    plan = gru_plan(BATCH, T, H)
    require(plan["plan"] == "cluster", "the 2024 serving shape does not take the cluster kernels")
    Hr = 1.0 / math.sqrt(H)
    xg_f, xg_b = (torch.randn(BATCH, T, 3 * H, generator=gen).to(dev) * 0.5 for _ in range(2))
    wf, wb = ((torch.rand(3 * H, H, generator=gen) * 2 - 1).to(dev) * Hr for _ in range(2))
    bf, bb = ((torch.rand(3 * H, generator=gen) * 2 - 1).to(dev) * Hr for _ in range(2))
    f, r = gru.bigru(xg_f, xg_b, wf, bf, wb, bb)
    fp, rp = gru.bigru_plain(xg_f, xg_b, wf, bf, wb, bb)
    err = max(rel_err(f, fp), rel_err(r, rp))
    f2, r2 = gru.bigru(xg_f, xg_b, wf, bf, wb, bb)
    same = torch.equal(f, f2) and torch.equal(r, r2)
    print(f"bigru          B={BATCH} T={T} H={H} {plan}: max err {err:.3e} (tol {TOL_KERNEL}); "
          f"rerun bitwise equal: {same}", flush=True)
    require(err <= TOL_KERNEL, "bigru disagrees with its plain version")
    require(same, "bigru is not bitwise repeatable")
    lib = torch.nn.GRU(IN, H, batch_first=True, bidirectional=True).to(dev)
    x_in = torch.randn(BATCH, T, IN, generator=gen).to(dev)
    gru_bytes = 4 * (2 * xg_f.numel() + 2 * (3 * H * H + 3 * H) + 2 * f.numel())
    gru_flops = 2 * T * BATCH * (2 * 3 * H * H + 12 * H)
    with torch.no_grad():
        rows["bigru"].append(dict(
            geom=[BATCH, T, H], steps=T, **plan,
            max_abs_err=float(max((f - fp).abs().max(), (r - rp).abs().max())),
            rel_err=err, ms=time_ms(lambda: gru.bigru(xg_f, xg_b, wf, bf, wb, bb)),
            plain_ms=time_ms(lambda: gru.bigru_plain(xg_f, xg_b, wf, bf, wb, bb), iters=3),
            library_ms=time_ms(lambda: lib(x_in)), bound=bound_ms(gru_bytes, gru_flops)))
    report["kernel_rows"] = rows
    report["wide_kernel_rows"] = wide
    for name, (r,) in wide.items():
        print(f"{name} at the {WIDE_GEOM[3]}-channel block (B={BATCH}): {r['ms']:.3f} ms, "
              f"bound {r['bound'][0]:.3f} ms ({r['bound'][1]}), plain {r['plain_ms']:.3f} ms",
              flush=True)
    return rows


def check_kernels_bf16(geoms, gen, report, rows32):
    """Phase 3b: the bf16 modes of rows 1 and 2 against their plain
    versions at B=64; returns timing rows."""
    import torch
    import torch.nn.functional as F

    from desed_task_tpu_torch.ops import fused_cnn

    dev, bf = torch.device("cuda"), torch.bfloat16
    rows = {"conv_bn_stats.bf16": [], "glu_drop_pool.bf16": []}
    wide = {"conv_bn_stats.bf16": [], "glu_drop_pool.bf16": []}
    B = BATCH
    for i, (T, Fq, ci, co, pool) in enumerate(list(geoms) + [WIDE_GEOM]):
        out = rows if i < len(geoms) else wide
        ref32 = rows32 if i < len(geoms) else report["wide_kernel_rows"]
        i32 = i if i < len(geoms) else 0
        x = torch.randn(B, T, Fq, ci, generator=gen).to(dev, bf)
        w = (torch.randn(3, 3, ci, co, generator=gen) / math.sqrt(9 * ci)).to(dev, bf)
        b = (torch.randn(co, generator=gen) * 0.1).to(dev, bf)
        y, s, q = fused_cnn.conv_bn_stats(x, w, b)
        yp, sp, qp = fused_cnn.conv_bn_stats_plain(x, w, b)
        ok, worst, frac = bf16_check(y, yp)
        # s and q against the plain version's, and against the sums of the
        # kernel's own rounded y (fp32 sums in another order, nothing else)
        err = max(rel_err(s, sp), rel_err(q, qp))
        yl = y.float().reshape(B * T, Fq * co)
        own = max(rel_err(s, yl.sum(0)), rel_err(q, (yl * yl).sum(0)))
        del yl
        same = all(torch.equal(u, v) for u, v in zip((y, s, q), fused_cnn.conv_bn_stats(x, w, b)))
        kernel = fused_cnn.FWD_KERNELS[fused_cnn.conv_fwd_plan(B, T, Fq, ci, co, bf16=True).kernel]
        print(f"conv_bn_stats.bf16  T={T:3d} F={Fq:3d} {ci:3d}->{co:3d} ({kernel}): y "
              f"{worst:.3f} of the limit, {frac:.2e} differ; s, q max err {err:.3e} against the "
              f"plain version, {own:.3e} against the sums of the kernel's y (tol {TOL_KERNEL}); "
              f"rerun bitwise equal: {same}", flush=True)
        # the persistent kernels at every 2024 block and at the 256-channel block
        require(kernel == ("conv_c1_bf16_kernel" if ci == 1 else "conv3x3_bf16_fwd_kernel"),
                f"conv_bn_stats bf16 takes {kernel} at {ci}->{co}")
        require(ok, "conv_bn_stats bf16 disagrees with its plain version")
        require(max(err, own) <= TOL_KERNEL, "conv_bn_stats bf16 statistics disagree")
        require(same, "conv_bn_stats bf16 is not bitwise repeatable")
        M = B * T * Fq
        n_bytes = 2 * (x.numel() + w.numel() + co + M * co) + 4 * 2 * Fq * co
        flops = 2 * 9 * ci * co * M
        x_nchw, w_oihw = x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1).contiguous()
        out["conv_bn_stats.bf16"].append(dict(
            geom=[T, Fq, ci, co], kernel=kernel,
            max_abs_err=float((y.float() - yp.float()).abs().max()),
            limit_share=worst, differ=frac, stats_err=err,
            ms=time_ms(lambda: fused_cnn.conv_bn_stats(x, w, b)),
            plain_ms=time_ms(lambda: fused_cnn.conv_bn_stats_plain(x, w, b), iters=3),
            library_ms=time_ms(lambda: F.conv2d(x_nchw, w_oihw, b, padding=1)),
            bound=bound_ms(n_bytes, flops, PEAK_BF16_FLOPS)))

        scale_f = (1.0 + 0.1 * torch.randn(Fq * co, generator=gen)).to(dev)
        bias_f = (0.1 * torch.randn(Fq * co, generator=gen)).to(dev)
        wg = (torch.randn(co, co, generator=gen) / math.sqrt(co)).to(dev, bf)
        bg = (0.1 * torch.randn(co, generator=gen)).to(dev, bf)
        bits = torch.randint(0, 256, (B, T, Fq * co), generator=gen, dtype=torch.uint8).to(dev)
        worsts, fracs, abs_errs = [], [], []
        for label, bb, keep in (("eval", None, 1.0), ("bits", bits, 0.5)):
            z = fused_cnn.glu_drop_pool(y, scale_f, bias_f, wg, bg, bb, pool=pool, keep_prob=keep)
            zp = fused_cnn.glu_drop_pool_plain(y, scale_f, bias_f, wg, bg, bb, pool=pool,
                                               keep_prob=keep)
            ok, worst, frac = bf16_check(z, zp)
            worsts.append(worst)
            fracs.append(frac)
            abs_errs.append(float((z.float() - zp.float()).abs().max()))
            same = torch.equal(z, fused_cnn.glu_drop_pool(y, scale_f, bias_f, wg, bg, bb,
                                                          pool=pool, keep_prob=keep))
            plan = fused_cnn.glu_fwd_plan(B, T, Fq, co, tuple(pool), bf16=True)
            kernel = "glu_fwd_frag_kernel" if plan.frag else "glu_fwd_ring_kernel"
            print(f"glu_drop_pool.bf16  T={T:3d} F={Fq:3d} Co={co:3d} pool={pool} {label} "
                  f"({kernel}): z {worst:.3f} of the limit, {frac:.2e} differ; rerun bitwise "
                  f"equal: {same}", flush=True)
            require(ok, "glu_drop_pool bf16 disagrees with its plain version")
            require(same, "glu_drop_pool bf16 is not bitwise repeatable")
        P = B * T * Fq
        n_bytes = 2 * (y.numel() + co * co + co + z.numel()) + 4 * 2 * Fq * co
        out["glu_drop_pool.bf16"].append(dict(
            geom=[T, Fq, co, *pool], max_abs_err=max(abs_errs), limit_share=max(worsts),
            differ=max(fracs),
            ms=time_ms(lambda: fused_cnn.glu_drop_pool(y, scale_f, bias_f, wg, bg, None,
                                                       pool=pool)),
            plain_ms=time_ms(lambda: fused_cnn.glu_drop_pool_plain(
                y, scale_f, bias_f, wg, bg, None, pool=pool), iters=3),
            library_ms=None, bound=bound_ms(n_bytes, P * (2 * co * co + 8 * co),
                                            PEAK_BF16_FLOPS)))
        for name, n32 in (("conv_bn_stats.bf16", "conv_bn_stats"),
                          ("glu_drop_pool.bf16", "glu_drop_pool")):
            r = out[name][-1]
            lib = f", F.conv2d bf16 {r['library_ms']:.3f} ms" if r["library_ms"] else ""
            where = f"block {i}" if i < len(geoms) else f"the {co}-channel block (not in the sums)"
            print(f"{name}  {where}: {r['ms']:.3f} ms (fp32 {ref32[n32][i32]['ms']:.3f}), bound "
                  f"{r['bound'][0]:.3f} ms ({r['bound'][1]}), plain {r['plain_ms']:.3f} ms{lib}",
                  flush=True)
        del x, y, yp, z, zp, bits
    r1 = rows["conv_bn_stats.bf16"]
    print(f"conv_bn_stats.bf16  sum of {len(r1)} blocks (each call: the conv kernel and "
          f"lane_stats_final_kernel): {sum(r['ms'] for r in r1):.3f} ms, bound "
          f"{sum(r['bound'][0] for r in r1):.3f} ms, F.conv2d bf16 "
          f"{sum(r['library_ms'] for r in r1):.3f} ms; kernels "
          f"{', '.join(r['kernel'] for r in r1)}", flush=True)
    report["bf16_kernel_rows"] = rows
    report["bf16_wide_kernel_rows"] = wide
    return rows


def serve(gen, report):
    """Phase 4: the serving path end to end, kernels against plain versions."""
    import torch

    from desed_task_tpu_torch.data.audio_io import write_wav
    from desed_task_tpu_torch.inference.pipeline import InferencePipeline
    from desed_task_tpu_torch.labels.encoder import ManyHotEncoder
    from desed_task_tpu_torch.ops import _build
    from desed_task_tpu_torch.ops.frontend import MelConfig
    from desed_task_tpu_torch.recipes_config import MEDIAN_2024, crnn_2024
    from desed_task_tpu_torch.utils.classes_dict import CLASSES_DESED, CLASSES_MAESTRO_REAL

    classes = list(CLASSES_DESED) + [c for c in CLASSES_MAESTRO_REAL if c not in CLASSES_DESED]
    enc = ManyHotEncoder(classes, 10, 2048, 256, 4, 16000)
    thresholds = tuple(np.arange(1 / 100, 1, 1 / 50))  # scripts/bench_infer.py's sweep
    rng = np.random.default_rng(0)
    bank = rng.standard_normal((BATCH, 768, 496)).astype(np.float32)

    def lookup(stems):
        return np.stack([bank[int(s.rsplit("_", 1)[1]) % BATCH] for s in stems])

    model = randomize(crnn_2024(), gen)
    plain = crnn_2024(fused_blocks=False, rnn_kernel=False)
    plain.load_state_dict(model.state_dict())
    kw = dict(median_filter=MEDIAN_2024, thresholds=thresholds, batch_size=BATCH, device="cuda")
    pipe = InferencePipeline(model, None, enc, **kw)
    pipe_plain = InferencePipeline(plain, None, enc, **kw)

    with tempfile.TemporaryDirectory() as tmp:
        wavs = []
        for i in range(N_CLIPS):
            p = Path(tmp) / f"clip_{i:04d}.wav"
            write_wav(p, rng.standard_normal(160000).astype(np.float32) * 0.1, 16000)
            wavs.append(p)
        n_batches = -(-N_CLIPS // BATCH)
        _build.reset_launches()
        t0 = time.perf_counter()
        scores, weak, events = pipe.run(wavs, embeddings_lookup=lookup)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
        want = {"conv_bn_stats": 7 * n_batches, "glu_drop_pool": 7 * n_batches,
                "bigru": n_batches}
        print(f"serving: {N_CLIPS} clips in {n_batches} batches of {BATCH}, "
              f"{run_s:.3f} s wall (decode included); launches {launches}, "
              f"expected {want}", flush=True)
        require(launches == want, "the serving run did not go through every kernel")
        scores_p, weak_p, _ = pipe_plain.run(wavs, embeddings_lookup=lookup)
        require(dict(_build.LAUNCHES) == launches, "the plain forward launched a kernel")
        bf16 = serve_bf16(model, pipe, enc, thresholds, wavs, lookup, report)

    require(len(scores) == N_CLIPS and len(weak) == N_CLIPS, "clips missing from the run")
    s_err = max(float(np.abs(scores[k] - scores_p[k]).max()) for k in scores)
    w_err = max(float(np.abs(weak[k] - weak_p[k]).max()) for k in weak)
    for k in scores:
        require(scores[k].shape == (27, 156) and weak[k].shape == (27,), f"{k}: bad shape")
        require(bool(np.isfinite(scores[k]).all() and np.isfinite(weak[k]).all()),
                f"{k}: non-finite scores")
    n_events = {th: len(rows) for th, rows in events.items()}
    print(f"serving: strong max err {s_err:.3e}, weak max err {w_err:.3e} "
          f"(tol {TOL_SCORES}) against the plain forward; events at 0.51: "
          f"{n_events[thresholds[25]]}", flush=True)
    require(s_err <= TOL_SCORES and w_err <= TOL_SCORES, "serving scores disagree")
    report["serving"] = dict(clips=N_CLIPS, batches=n_batches, wall_s=run_s,
                             launches=launches, strong_err=s_err, weak_err=w_err)

    # phase 5a: the device program per batch, and its stages
    from desed_task_tpu_torch.ops.frontend import log_mel_spectrogram
    from desed_task_tpu_torch.ops.scaler import apply_scaler

    audio = torch.as_tensor(rng.standard_normal((BATCH, 160000)).astype(np.float32) * 0.1,
                            device="cuda")
    emb = torch.as_tensor(bank, device="cuda")
    mel = MelConfig()
    with torch.inference_mode():
        feats = apply_scaler(log_mel_spectrogram(audio, mel), pipe.scaler_cfg)
        times = dict(
            forward_ms=time_ms(lambda: pipe.forward(audio, emb)),
            plain_forward_ms=time_ms(lambda: pipe_plain.forward(audio, emb), iters=3),
            frontend_ms=time_ms(lambda: apply_scaler(log_mel_spectrogram(audio, mel),
                                                     pipe.scaler_cfg)),
            model_ms=time_ms(lambda: model(feats, embeddings=emb)),
        )
    report["forward"] = times
    # phase 5b: the bf16 device forward per batch, and its stages
    pipe16 = bf16["pipe"]
    with torch.inference_mode():
        feats16 = apply_scaler(log_mel_spectrogram(audio, pipe16.mel_cfg), pipe16.scaler_cfg)
        report["forward_bf16"] = dict(
            forward_ms=time_ms(lambda: pipe16.forward(audio, emb)),
            frontend_ms=time_ms(lambda: apply_scaler(log_mel_spectrogram(audio, pipe16.mel_cfg),
                                                     pipe16.scaler_cfg)),
            model_ms=time_ms(lambda: pipe16.model(feats16, embeddings=emb)),
        )
    return launches, pipe, bf16["launches"]


def serve_bf16(model32, pipe32, enc, thresholds, wavs, lookup, report):
    """Phase 4b: the bf16 serving configuration of scripts/bench_infer.py
    (bf16_fast) through the same entry point, against the same bf16 forward
    through the plain versions on the CPU."""
    import torch

    from desed_task_tpu_torch.inference.pipeline import InferencePipeline
    from desed_task_tpu_torch.ops import _build
    from desed_task_tpu_torch.ops.frontend import MelConfig
    from desed_task_tpu_torch.recipes_config import MEDIAN_2024, crnn_2024

    mel16 = MelConfig(compute_dtype="bfloat16")
    state = {k: v.detach().cpu() for k, v in model32.state_dict().items()}
    kw = dict(mel_cfg=mel16, median_filter=MEDIAN_2024, thresholds=thresholds,
              batch_size=BATCH)
    pipe = InferencePipeline(crnn_2024(compute_dtype=torch.bfloat16), state, enc, **kw,
                             device="cuda")
    n_batches = -(-len(wavs) // BATCH)
    _build.reset_launches()
    t0 = time.perf_counter()
    scores, weak, _ = pipe.run(wavs, embeddings_lookup=lookup)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    want = {"conv_bn_stats.bf16": 7 * n_batches, "glu_drop_pool.bf16": 7 * n_batches,
            "bigru": n_batches}
    print(f"serving bf16: {len(wavs)} clips in {n_batches} batches of {BATCH}, {run_s:.3f} s "
          f"wall; launches {launches}, expected {want}", flush=True)
    require(launches == want, "the bf16 serving run did not go through every bf16 kernel")
    require(len(scores) == len(wavs) and all(
        bool(np.isfinite(scores[k]).all() and np.isfinite(weak[k]).all()) for k in scores),
        "bf16 serving: clips missing or non-finite scores")

    # 8 clips: the bf16 features of the card's front-end into the bf16 CRNN
    # on the card and through the plain versions on the CPU; the fp32
    # forward of the same audio on the card
    from desed_task_tpu_torch.ops.frontend import log_mel_spectrogram
    from desed_task_tpu_torch.ops.median import classwise_median_filter
    from desed_task_tpu_torch.ops.scaler import apply_scaler

    chunk = [str(w) for w in wavs[:N_CPU_CLIPS]]
    audio = torch.as_tensor(pipe._load_batch(chunk), device="cuda")
    emb = torch.as_tensor(lookup([Path(c).stem for c in chunk]), device="cuda")
    cpu_model = crnn_2024(compute_dtype=torch.bfloat16)
    cpu_model.load_state_dict(state)
    cpu_model.eval()
    with torch.inference_mode():
        feats = apply_scaler(log_mel_spectrogram(audio, mel16), pipe.scaler_cfg)
        x = feats.transpose(-1, -2)[..., None].contiguous()
        z_card = pipe.model.cnn(x, train=False).float().cpu()
        z_fp32 = pipe32.model.cnn(x, train=False).float().cpu()
        out_card = pipe.model(feats, embeddings=emb)
        _build.reset_launches()
        z_cpu = cpu_model.cnn(x.cpu(), train=False).float()
        out_cpu = cpu_model(feats.cpu(), embeddings=emb.cpu())
        require(dict(_build.LAUNCHES) == {}, "the CPU forward launched a kernel")
        s32, w32, _ = pipe32.forward(audio, emb)
    med = lambda s: classwise_median_filter(s, pipe.median, class_axis=-2, time_axis=-1)
    card = (med(out_card[0]).float().cpu(), out_card[1].float().cpu())
    cpu = (med(out_cpu[0]).float(), out_cpu[1].float())
    fp32 = (s32.float().cpu(), w32.float().cpu())
    same = float((z_card == z_cpu).float().mean())
    zgap_cpu = float((z_card - z_cpu).abs().mean())
    zgap_fp32 = float((z_card - z_fp32).abs().mean())
    gap_cpu = max(float((card[j] - cpu[j]).abs().max()) for j in range(2))
    gap_fp32 = max(float((card[j] - fp32[j]).abs().max()) for j in range(2))
    z_share, s_share = zgap_cpu / max(zgap_fp32, 1e-30), gap_cpu / max(gap_fp32, 1e-30)
    print(f"serving bf16 on {N_CPU_CLIPS} clips, from the same bf16 features, against the plain "
          f"bf16 CRNN on the CPU: the conv stack's output bitwise equal on {same:.4%} of its "
          f"elements, mean |diff| {zgap_cpu:.3e} against {zgap_fp32:.3e} from the fp32 conv "
          f"stack on the card (share {z_share:.3f}); scores max |diff| {gap_cpu:.3e} against "
          f"{gap_fp32:.3e} from the fp32 forward (share {s_share:.3f}); limit: shares below "
          f"{BF16_NEARER:.1f}", flush=True)
    require(zgap_fp32 > 0 and z_share < BF16_NEARER,
            "bf16 serving: the conv stack's output is no nearer the plain bf16 CRNN than fp32")
    require(gap_fp32 > 0 and s_share < BF16_NEARER,
            "bf16 serving scores are no nearer the plain bf16 forward than the fp32 one")
    report["serving_bf16"] = dict(clips=len(wavs), batches=n_batches, wall_s=run_s,
                                  launches=launches, features_equal=same,
                                  features_gap_cpu=zgap_cpu, features_gap_fp32=zgap_fp32,
                                  gap_cpu=gap_cpu, gap_fp32=gap_fp32)
    return dict(pipe=pipe, launches=launches)


def check_bwd_kernels(geoms, gen, report):
    """Phase 6: every backward kernel against its plain version at B=60;
    returns timing rows (phase 8)."""
    import torch
    import torch.nn.functional as F

    from desed_task_tpu_torch.ops import fused_cnn, gru

    dev = torch.device("cuda")
    B = TRAIN_BATCH
    rows = {"conv_bn_stats_bwd": [], "glu_drop_pool_bwd": [], "bigru_bwd": []}
    for i, (T, Fq, ci, co, pool) in enumerate(geoms):
        x = torch.randn(B, T, Fq, ci, generator=gen).to(dev)
        w = (torch.randn(3, 3, ci, co, generator=gen) / math.sqrt(9 * ci)).to(dev)
        y = torch.randn(B, T, Fq, co, generator=gen).to(dev)
        # unit-scale cotangents, so that TOL_KERNEL of max(1, max |plain|) is
        # small against every output it guards
        dy = torch.randn(B, T, Fq, co, generator=gen).to(dev)
        ds = torch.randn(Fq * co, generator=gen).to(dev)
        dq = torch.randn(Fq * co, generator=gen).to(dev)
        need_dx = i > 0  # the train step needs no gradient of the features
        errs, abs_errs = [], []
        for nd in {True, need_dx}:
            got = fused_cnn.conv_bn_stats_bwd(x, w, y, dy, ds, dq, nd)
            want = fused_cnn.conv_bn_stats_bwd_plain(x, w, y, dy, ds, dq, nd)
            for a, b in zip(got, want):
                if b is not None:
                    errs.append(rel_err(a, b))
                    abs_errs.append(float((a - b).abs().max()))
        again = fused_cnn.conv_bn_stats_bwd(x, w, y, dy, ds, dq, need_dx)
        require(all(torch.equal(a, b) for a, b in zip(got[1:], again[1:])),
                "conv_bn_stats_bwd is not bitwise repeatable")
        print(f"conv_bn_stats_bwd  T={T:3d} F={Fq:3d} {ci:3d}->{co:3d}: max err "
              f"{max(errs):.3e} (tol {TOL_KERNEL})", flush=True)
        require(max(errs) <= TOL_KERNEL, "conv_bn_stats_bwd disagrees with its plain version")
        M = B * T * Fq
        n_bytes = 4 * (x.numel() + 2 * y.numel() + 2 * w.numel() + 2 * Fq * co + co
                       + (x.numel() if need_dx else 0))
        flops = 2 * M * 9 * ci * co * (2 if need_dx else 1) + 4 * M * co
        x_nchw = x.permute(0, 3, 1, 2).requires_grad_(need_dx)
        w_oihw = w.permute(3, 2, 0, 1).contiguous().requires_grad_()
        bb = torch.zeros(co, device=dev, requires_grad=True)
        out = F.conv2d(x_nchw, w_oihw, bb, padding=1)
        g_out = dy.permute(0, 3, 1, 2)
        lib_in = [w_oihw, bb] + ([x_nchw] if need_dx else [])
        rows["conv_bn_stats_bwd"].append(dict(
            geom=[T, Fq, ci, co], max_abs_err=max(abs_errs), rel_err=max(errs),
            ms=time_ms(lambda: fused_cnn.conv_bn_stats_bwd(x, w, y, dy, ds, dq, need_dx)),
            plain_ms=time_ms(lambda: fused_cnn.conv_bn_stats_bwd_plain(
                x, w, y, dy, ds, dq, need_dx), iters=3),
            library_ms=time_ms(lambda: torch.autograd.grad(out, lib_in, g_out,
                                                           retain_graph=True)),
            bound=bound_ms(n_bytes, flops)))
        del out, x_nchw
        r = rows["conv_bn_stats_bwd"][-1]
        print(f"conv_bn_stats_bwd  block {i}: {r['ms']:.3f} ms, bound {r['bound'][0]:.3f} ms "
              f"({r['bound'][1]}), plain {r['plain_ms']:.3f} ms, cuDNN conv backward "
              f"{r['library_ms']:.3f} ms", flush=True)

        scale_f = (1.0 + 0.1 * torch.randn(Fq * co, generator=gen)).to(dev)
        bias_f = (0.1 * torch.randn(Fq * co, generator=gen)).to(dev)
        wg = (torch.randn(co, co, generator=gen) / math.sqrt(co)).to(dev)
        bg = (0.1 * torch.randn(co, generator=gen)).to(dev)
        gz = torch.randn(B, T // pool[0], Fq // pool[1], co, generator=gen).to(dev)
        bits = torch.randint(0, 256, (B, T, Fq * co), generator=gen, dtype=torch.uint8).to(dev)
        errs, abs_errs = [], []
        for label, bt, keep in (("eval", None, 1.0), ("bits", bits, 0.5)):
            got = fused_cnn.glu_drop_pool_bwd(y, scale_f, bias_f, wg, bg, bt, gz, pool=pool,
                                              keep_prob=keep)
            want = fused_cnn.glu_drop_pool_bwd_plain(y, scale_f, bias_f, wg, bg, bt, gz,
                                                     pool=pool, keep_prob=keep)
            e = max(rel_err(a, b) for a, b in zip(got, want))
            errs.append(e)
            abs_errs.append(max(float((a - b).abs().max()) for a, b in zip(got, want)))
            print(f"glu_drop_pool_bwd  T={T:3d} F={Fq:3d} Co={co:3d} pool={pool} {label}: "
                  f"max err {e:.3e} (tol {TOL_KERNEL})", flush=True)
            require(e <= TOL_KERNEL, "glu_drop_pool_bwd disagrees with its plain version")
        again = fused_cnn.glu_drop_pool_bwd(y, scale_f, bias_f, wg, bg, bits, gz, pool=pool,
                                            keep_prob=0.5)
        require(all(torch.equal(a, b) for a, b in zip(got, again)),
                "glu_drop_pool_bwd is not bitwise repeatable")
        P = B * T * Fq
        n_bytes = (4 * (2 * y.numel() + gz.numel() + 4 * Fq * co + 2 * co * co + 2 * co)
                   + bits.numel())
        flops = P * (6 * co * co + 20 * co)
        rows["glu_drop_pool_bwd"].append(dict(
            geom=[T, Fq, co, *pool], max_abs_err=max(abs_errs), rel_err=max(errs),
            ms=time_ms(lambda: fused_cnn.glu_drop_pool_bwd(
                y, scale_f, bias_f, wg, bg, bits, gz, pool=pool, keep_prob=0.5)),
            plain_ms=time_ms(lambda: fused_cnn.glu_drop_pool_bwd_plain(
                y, scale_f, bias_f, wg, bg, bits, gz, pool=pool, keep_prob=0.5), iters=3),
            library_ms=None, bound=bound_ms(n_bytes, flops)))
        r = rows["glu_drop_pool_bwd"][-1]
        print(f"glu_drop_pool_bwd  block {i}: {r['ms']:.3f} ms, bound {r['bound'][0]:.3f} ms "
              f"({r['bound'][1]}), plain {r['plain_ms']:.3f} ms", flush=True)
        del x, y, dy, bits, got, want, again

    T, H, IN = geoms[-1][0], 192, 128
    plan = gru_plan(B, T, H)
    require(plan["plan"] == "cluster", "the 2024 train shape does not take the cluster kernels")
    Hr = 1.0 / math.sqrt(H)
    xg_f, xg_b = (torch.randn(B, T, 3 * H, generator=gen).to(dev) * 0.5 for _ in range(2))
    wf, wb = ((torch.rand(3 * H, H, generator=gen) * 2 - 1).to(dev) * Hr for _ in range(2))
    bf, bb = ((torch.rand(3 * H, generator=gen) * 2 - 1).to(dev) * Hr for _ in range(2))
    args = (xg_f, xg_b, wf, bf, wb, bb)
    f, r = gru.bigru(*args)
    df, dr = (torch.randn(B, T, H, generator=gen).to(dev) for _ in range(2))
    got = gru.bigru_bwd(*args, f, r, df, dr)
    want = gru.bigru_bwd_plain(*args, f, r, df, dr)
    err = max(rel_err(a, b) for a, b in zip(got, want))
    print(f"bigru_bwd          B={B} T={T} H={H} {plan}: max err {err:.3e} "
          f"(tol {TOL_KERNEL})", flush=True)
    require(err <= TOL_KERNEL, "bigru_bwd disagrees with its plain version")
    require(all(torch.equal(a, b) for a, b in zip(got, gru.bigru_bwd(*args, f, r, df, dr))),
            "bigru_bwd is not bitwise repeatable")
    lib = torch.nn.GRU(IN, H, batch_first=True, bidirectional=True).to(dev)
    x_in = torch.randn(B, T, IN, generator=gen).to(dev).requires_grad_()
    lib_out, _ = lib(x_in)
    g_lib = torch.randn(lib_out.shape, generator=gen).to(dev)
    lib_in = [x_in, *lib.parameters()]
    n_bytes = 4 * (2 * xg_f.numel() + 4 * f.numel() + 2 * xg_f.numel()
                   + 4 * (3 * H * H + 3 * H))
    flops = 2 * T * B * (2 * 2 * 3 * H * H + 30 * H) + 2 * 2 * B * T * 3 * H * H
    rows["bigru_bwd"].append(dict(
        geom=[B, T, H], steps=T, **plan,
        max_abs_err=max(float((a - b).abs().max()) for a, b in zip(got, want)),
        rel_err=err, ms=time_ms(lambda: gru.bigru_bwd(*args, f, r, df, dr)),
        plain_ms=time_ms(lambda: gru.bigru_bwd_plain(*args, f, r, df, dr), iters=3),
        library_ms=time_ms(lambda: torch.autograd.grad(lib_out, lib_in, g_lib,
                                                       retain_graph=True)),
        bound=bound_ms(n_bytes, flops)))
    report["bwd_kernel_rows"] = rows
    report["gru_stream"] = check_gru_stream(gen)
    report["wide_bwd_row"] = check_wide_glu_bwd(gen)
    return rows


def check_wide_glu_bwd(gen) -> dict:
    """glu_drop_pool_bwd at the 256-channel block (B=60): the wide kernel
    (Wg in slices, dWg in passes) against its plain version, unit-scale
    cotangents, bitwise rerun; its time beside its bound (not in the sums)."""
    import torch

    from desed_task_tpu_torch.ops import fused_cnn

    dev, B = torch.device("cuda"), TRAIN_BATCH
    T, Fq, _, co, pool = WIDE_GEOM
    plan = fused_cnn.glu_bwd_plan(B, T, Fq, co)
    require(plan.passes > 1, "the 256-channel block does not take the wide kernel")
    y = torch.randn(B, T, Fq, co, generator=gen).to(dev)
    scale_f = (1.0 + 0.1 * torch.randn(Fq * co, generator=gen)).to(dev)
    bias_f = (0.1 * torch.randn(Fq * co, generator=gen)).to(dev)
    wg = (torch.randn(co, co, generator=gen) / math.sqrt(co)).to(dev)
    bg = (0.1 * torch.randn(co, generator=gen)).to(dev)
    gz = torch.randn(B, T // pool[0], Fq // pool[1], co, generator=gen).to(dev)
    bits = torch.randint(0, 256, (B, T, Fq * co), generator=gen, dtype=torch.uint8).to(dev)
    args = (y, scale_f, bias_f, wg, bg, bits, gz)
    got = fused_cnn.glu_drop_pool_bwd(*args, pool=pool, keep_prob=0.5)
    want = fused_cnn.glu_drop_pool_bwd_plain(*args, pool=pool, keep_prob=0.5)
    err = max(rel_err(a, b) for a, b in zip(got, want))
    same = all(torch.equal(a, b) for a, b in zip(
        got, fused_cnn.glu_drop_pool_bwd(*args, pool=pool, keep_prob=0.5)))
    P = B * T * Fq
    n_bytes = (4 * (2 * y.numel() + gz.numel() + 4 * Fq * co + 2 * co * co + 2 * co)
               + bits.numel())
    row = dict(geom=[B, T, Fq, co, *pool], plan=plan.ints(), rel_err=err, bitwise=same,
               ms=time_ms(lambda: fused_cnn.glu_drop_pool_bwd(*args, pool=pool, keep_prob=0.5)),
               bound=bound_ms(n_bytes, P * (6 * co * co + 20 * co)))
    print(f"glu_drop_pool_bwd at the {co}-channel block (B={B}, wide kernel: slices of "
          f"{plan.ks} rows, {plan.passes} dWg passes): max err {err:.3e} (tol {TOL_KERNEL}); "
          f"rerun bitwise equal: {same}; {row['ms']:.3f} ms, bound {row['bound'][0]:.3f} ms "
          f"({row['bound'][1]})", flush=True)
    require(err <= TOL_KERNEL, "glu_drop_pool_bwd (wide) disagrees with its plain version")
    require(same, "glu_drop_pool_bwd (wide) is not bitwise repeatable")
    return row


def glu_bwd_bf16_bound(P: int, co: int, n_bytes: float) -> tuple[float, str]:
    """Row 4 in bf16: lin is a product of bf16 values (the tensor cores'
    peak); dlin Wg^T and BN(y)^T dlin take fp32 dlin (the fp32 peak)."""
    tb = n_bytes / PEAK_BYTES * 1e3
    tf = (P * 2 * co * co / PEAK_BF16_FLOPS + P * (4 * co * co + 20 * co) / PEAK_FP32_FLOPS) * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def glu_bwd_kernel_name(B: int, T: int, F: int, co: int) -> str:
    """The CUDA kernel that the bf16 glu_drop_pool_bwd's plan picks."""
    from desed_task_tpu_torch.ops import fused_cnn

    plan = fused_cnn.glu_bwd_plan(B, T, F, co, bf16=True)
    return ("glu_bwd_frag_kernel" if plan.frag else
            "glu_bwd_kernel (wide)" if plan.passes > 1 else "glu_bwd_kernel")


def check_bwd_kernels_bf16(geoms, gen, report, rows32):
    """Phase 6b: the bf16 modes of rows 3 and 4 against their bf16 plain
    versions at B=60; returns timing rows."""
    import torch
    import torch.nn.functional as F

    from desed_task_tpu_torch.ops import fused_cnn

    dev, bf = torch.device("cuda"), torch.bfloat16
    B = TRAIN_BATCH
    rows = {"conv_bn_stats_bwd.bf16": [], "glu_drop_pool_bwd.bf16": []}

    def check_glu(T, Fq, co, pool):
        y = torch.randn(B, T, Fq, co, generator=gen).to(dev, bf)
        scale_f = (1.0 + 0.1 * torch.randn(Fq * co, generator=gen)).to(dev)
        bias_f = (0.1 * torch.randn(Fq * co, generator=gen)).to(dev)
        wg = (torch.randn(co, co, generator=gen) / math.sqrt(co)).to(dev, bf)
        bg = (0.1 * torch.randn(co, generator=gen)).to(dev, bf)
        gz = torch.randn(B, T // pool[0], Fq // pool[1], co, generator=gen).to(dev, bf)
        bits = torch.randint(0, 256, (B, T, Fq * co), generator=gen, dtype=torch.uint8).to(dev)
        worsts, fracs, errs, abs_errs = [], [], [], []
        for label, bt, keep in (("eval", None, 1.0), ("bits", bits, 0.5)):
            got = fused_cnn.glu_drop_pool_bwd(y, scale_f, bias_f, wg, bg, bt, gz, pool=pool,
                                              keep_prob=keep)
            want = fused_cnn.glu_drop_pool_bwd_plain(y, scale_f, bias_f, wg, bg, bt, gz,
                                                     pool=pool, keep_prob=keep)
            require([a.dtype for a in got] == [bf, torch.float32, torch.float32, bf, bf],
                    "glu_drop_pool_bwd bf16: output dtypes")
            ok = True
            for j, (a, b) in enumerate(zip(got, want)):
                if a.dtype == bf:
                    good, worst, frac = bf16_check(a, b, sums=j == 4)  # dbg
                    ok, worsts, fracs = ok and good, worsts + [worst], fracs + [frac]
                else:
                    errs.append(rel_err(a, b))
                abs_errs.append(float((a.float() - b.float()).abs().max()))
            same = all(torch.equal(a, b) for a, b in zip(got, fused_cnn.glu_drop_pool_bwd(
                y, scale_f, bias_f, wg, bg, bt, gz, pool=pool, keep_prob=keep)))
            print(f"glu_drop_pool_bwd.bf16  T={T:3d} F={Fq:3d} Co={co:3d} pool={pool} {label}: "
                  f"dy, dwg, dbg {max(worsts):.3f} of the limit, {max(fracs):.2e} differ; "
                  f"dscale_f, dbias_f max err {max(errs):.3e} (tol {TOL_KERNEL}); rerun "
                  f"bitwise equal: {same}", flush=True)
            require(ok, "glu_drop_pool_bwd bf16 disagrees with its plain version")
            require(max(errs) <= TOL_KERNEL, "glu_drop_pool_bwd bf16 sums disagree")
            require(same, "glu_drop_pool_bwd bf16 is not bitwise repeatable")
        P = B * T * Fq
        n_bytes = 2 * (2 * y.numel() + gz.numel() + 2 * co * co + 2 * co) + 4 * 4 * Fq * co \
            + bits.numel()
        args = (y, scale_f, bias_f, wg, bg, bits, gz)
        return dict(
            geom=[T, Fq, co, *pool], kernel=glu_bwd_kernel_name(B, T, Fq, co),
            max_abs_err=max(abs_errs), limit_share=max(worsts),
            differ=max(fracs), rel_err=max(errs),
            ms=time_ms(lambda: fused_cnn.glu_drop_pool_bwd(*args, pool=pool, keep_prob=0.5)),
            plain_ms=time_ms(lambda: fused_cnn.glu_drop_pool_bwd_plain(
                *args, pool=pool, keep_prob=0.5), iters=3),
            library_ms=None, bound=glu_bwd_bf16_bound(P, co, n_bytes))

    for i, (T, Fq, ci, co, pool) in enumerate(geoms):
        x = torch.randn(B, T, Fq, ci, generator=gen).to(dev, bf)
        w = (torch.randn(3, 3, ci, co, generator=gen) / math.sqrt(9 * ci)).to(dev, bf)
        y = torch.randn(B, T, Fq, co, generator=gen).to(dev, bf)
        dy = torch.randn(B, T, Fq, co, generator=gen).to(dev, bf)
        ds = torch.randn(Fq * co, generator=gen).to(dev)
        dq = torch.randn(Fq * co, generator=gen).to(dev)
        need_dx = i > 0
        worsts, fracs, abs_errs = [], [], []
        for nd in {True, need_dx}:
            got = fused_cnn.conv_bn_stats_bwd(x, w, y, dy, ds, dq, nd)
            want = fused_cnn.conv_bn_stats_bwd_plain(x, w, y, dy, ds, dq, nd)
            for j, (a, b) in enumerate(zip(got, want)):
                if b is not None:
                    require(a.dtype == bf, "conv_bn_stats_bwd bf16: output dtype")
                    ok, worst, frac = bf16_check(a, b, sums=j == 2)  # dbias
                    require(ok, f"conv_bn_stats_bwd bf16 disagrees with its plain version "
                                f"({worst:.3f} of the limit, {frac:.2e} differ)")
                    worsts.append(worst)
                    fracs.append(frac)
                    abs_errs.append(float((a.float() - b.float()).abs().max()))
        again = fused_cnn.conv_bn_stats_bwd(x, w, y, dy, ds, dq, need_dx)
        same = all(torch.equal(a, b) for a, b in zip(
            fused_cnn.conv_bn_stats_bwd(x, w, y, dy, ds, dq, need_dx)[1:], again[1:]))
        print(f"conv_bn_stats_bwd.bf16  T={T:3d} F={Fq:3d} {ci:3d}->{co:3d}: dx, dw, dbias "
              f"{max(worsts):.3f} of the limit, {max(fracs):.2e} differ; rerun bitwise equal: "
              f"{same}", flush=True)
        require(same, "conv_bn_stats_bwd bf16 is not bitwise repeatable")
        M = B * T * Fq
        n_bytes = (2 * (x.numel() + 2 * y.numel() + 2 * w.numel() + co
                        + (x.numel() if need_dx else 0)) + 4 * 2 * Fq * co)
        flops = 2 * M * 9 * ci * co * (2 if need_dx else 1)
        x_nchw = x.permute(0, 3, 1, 2).requires_grad_(need_dx)
        w_oihw = w.permute(3, 2, 0, 1).contiguous().requires_grad_()
        bb = torch.zeros(co, device=dev, dtype=bf, requires_grad=True)
        out = F.conv2d(x_nchw, w_oihw, bb, padding=1)
        g_out = dy.permute(0, 3, 1, 2)
        lib_in = [w_oihw, bb] + ([x_nchw] if need_dx else [])
        rows["conv_bn_stats_bwd.bf16"].append(dict(
            geom=[T, Fq, ci, co], max_abs_err=max(abs_errs), limit_share=max(worsts),
            differ=max(fracs),
            ms=time_ms(lambda: fused_cnn.conv_bn_stats_bwd(x, w, y, dy, ds, dq, need_dx)),
            plain_ms=time_ms(lambda: fused_cnn.conv_bn_stats_bwd_plain(
                x, w, y, dy, ds, dq, need_dx), iters=3),
            library_ms=time_ms(lambda: torch.autograd.grad(out, lib_in, g_out,
                                                           retain_graph=True)),
            bound=bound_ms(n_bytes, flops + 4 * M * co, PEAK_BF16_FLOPS)))
        del out, x_nchw, x, y, dy, got, want, again
        require(glu_bwd_kernel_name(B, T, Fq, co) == "glu_bwd_frag_kernel",
                f"block {i}: the bf16 GLU backward does not take glu_bwd_frag_kernel")
        rows["glu_drop_pool_bwd.bf16"].append(check_glu(T, Fq, co, pool))
        for name, n32 in (("conv_bn_stats_bwd.bf16", "conv_bn_stats_bwd"),
                          ("glu_drop_pool_bwd.bf16", "glu_drop_pool_bwd")):
            r = rows[name][-1]
            lib = (f", cuDNN conv backward bf16 {r['library_ms']:.3f} ms"
                   if r["library_ms"] else "")
            kern = f" [{r['kernel']}]" if "kernel" in r else ""
            print(f"{name}  block {i}{kern}: {r['ms']:.3f} ms (fp32 "
                  f"{rows32[n32][i]['ms']:.3f}), bound {r['bound'][0]:.3f} ms ({r['bound'][1]}), "
                  f"plain {r['plain_ms']:.3f} ms{lib}", flush=True)
    r3 = rows["conv_bn_stats_bwd.bf16"]
    print(f"conv_bn_stats_bwd.bf16  sum of {len(r3)} blocks: {sum(r['ms'] for r in r3):.3f} ms, "
          f"cuDNN conv backward bf16 {sum(r['library_ms'] for r in r3):.3f} ms (this call), "
          f"bound {sum(r['bound'][0] for r in r3):.3f} ms", flush=True)
    T, Fq, _, co, pool = WIDE_GEOM
    require(glu_bwd_kernel_name(B, T, Fq, co) == "glu_bwd_kernel (wide)",
            "the 256-channel block does not take the wide kernel")
    wide = check_glu(T, Fq, co, pool)
    r4 = rows["glu_drop_pool_bwd.bf16"]
    print(f"glu_drop_pool_bwd.bf16  sum of {len(r4)} blocks: {sum(r['ms'] for r in r4):.3f} ms, "
          f"bound {sum(r['bound'][0] for r in r4):.3f} ms", flush=True)
    print(f"glu_drop_pool_bwd.bf16 at the {co}-channel block (B={B}, {wide['kernel']}): "
          f"{wide['ms']:.3f} ms, bound {wide['bound'][0]:.3f} ms ({wide['bound'][1]}), "
          f"plain {wide['plain_ms']:.3f} ms", flush=True)
    report["bf16_bwd_kernel_rows"] = rows
    report["wide_bwd_row_bf16"] = wide
    return rows


def gru_plan(B: int, T: int, H: int) -> dict:
    """The BiGRU kernels' plan at a shape: "cluster" (with its cluster size
    and batch rows) or "stream"."""
    from desed_task_tpu_torch.ops import gru

    plan, lay = gru.bigru_config(B, T, H)
    return dict(plan=plan, C=lay.C if lay else None, BT=gru.CLUSTER_ROWS if lay else None)


def check_gru_stream(gen) -> dict:
    """The BiGRU's stream kernels (hidden sizes whose W_hh slices do not fit
    a cluster), forward and backward, against the plain versions at H=512."""
    import torch

    from desed_task_tpu_torch.ops import gru

    B, T, H = 8, 32, 512
    require(gru_plan(B, T, H)["plan"] == "stream", "H=512 does not take the stream kernels")
    dev = torch.device("cuda")
    Hr = 1.0 / math.sqrt(H)
    args = [(torch.randn(B, T, 3 * H, generator=gen) * 0.5).to(dev) for _ in range(2)]
    args[2:2] = [((torch.rand(3 * H, H, generator=gen) * 2 - 1) * Hr).to(dev),
                 ((torch.rand(3 * H, generator=gen) * 2 - 1) * Hr).to(dev)]
    args += [((torch.rand(3 * H, H, generator=gen) * 2 - 1) * Hr).to(dev),
             ((torch.rand(3 * H, generator=gen) * 2 - 1) * Hr).to(dev)]
    f, r = gru.bigru(*args)
    err_f = max(rel_err(a, b) for a, b in zip((f, r), gru.bigru_plain(*args)))
    df, dr = (torch.randn(B, T, H, generator=gen).to(dev) for _ in range(2))
    err_b = max(rel_err(a, b) for a, b in zip(gru.bigru_bwd(*args, f, r, df, dr),
                                              gru.bigru_bwd_plain(*args, f, r, df, dr)))
    print(f"bigru stream   B={B} T={T} H={H}: forward max err {err_f:.3e}, backward "
          f"{err_b:.3e} (tol {TOL_KERNEL})", flush=True)
    require(max(err_f, err_b) <= TOL_KERNEL,
            "the BiGRU stream kernels disagree with the plain versions")
    return dict(geom=[B, T, H], fwd_err=err_f, bwd_err=err_b)


def train(gen, report):
    """Phases 7 and 8a: the 2024 mean-teacher step on the card."""
    import torch

    from desed_task_tpu_torch.ops import _build
    from desed_task_tpu_torch.recipes_config import crnn_2024, mean_teacher_2024
    from desed_task_tpu_torch.training import create_state, make_optimizer, make_train_step

    cfg = mean_teacher_2024()
    require(cfg.batch_size == TRAIN_BATCH, "mean_teacher_2024() is not 60 clips")
    n_class, t_lab = 27, 156
    rng = np.random.default_rng(1)
    dev = torch.device("cuda")
    batch = {}
    for s in cfg.slots:
        batch[s.name] = {
            "audio": torch.as_tensor(rng.standard_normal((s.size, 160000), np.float32) * 0.05,
                                     device=dev),
            "labels": torch.as_tensor((rng.random((s.size, n_class, t_lab)) > 0.95)
                                      .astype(np.float32), device=dev),
            "embeddings": torch.as_tensor(rng.standard_normal((s.size, 768, 496), np.float32),
                                          device=dev),
            "class_mask": torch.ones((s.size, n_class), dtype=torch.bool, device=dev),
        }
    init = {k: v.clone() for k, v in randomize(crnn_2024(), gen).state_dict().items()}
    tx, sched = make_optimizer(lr=1e-3, rampup_steps=1000)
    step = make_train_step(cfg, tx, sched)

    def fresh(kernels: bool):
        model = crnn_2024() if kernels else crnn_2024(fused_blocks=False, rnn_kernel=False)
        model.load_state_dict(init)
        return create_state(model, cfg, tx, device="cuda")

    def run(state, seed=7):
        metrics = step(state, batch, torch.Generator(device="cuda").manual_seed(seed))
        torch.cuda.synchronize()
        return ({k: float(v) for k, v in metrics.items()},
                [p.grad.clone() for p in state.student.parameters()])

    state = fresh(True)
    _build.reset_launches()
    metrics, grads = run(state)
    launches = dict(_build.LAUNCHES)
    want = {"conv_bn_stats": 14, "glu_drop_pool": 14, "bigru": 2,
            "conv_bn_stats_bwd": 7, "glu_drop_pool_bwd": 7, "bigru_bwd": 1}
    print(f"train step: launches {launches}, expected {want}", flush=True)
    require(launches == want, "the train step did not go through every kernel")
    print("train step metrics: " + ", ".join(f"{k} {v:.6g}" for k, v in metrics.items()),
          flush=True)
    require(all(math.isfinite(v) for v in metrics.values()), "non-finite train metrics")

    plain = fresh(False)
    p_metrics, p_grads = run(plain)
    require(dict(_build.LAUNCHES) == launches, "the plain step launched a kernel")
    loss_err = max(abs(metrics[k] - p_metrics[k]) / max(abs(p_metrics[k]), 1e-6)
                   for k in metrics)
    names = [n for n, _ in state.student.named_parameters()]
    grad_errs = {n: float((a - b).abs().max()) / max(float(b.abs().max()), 1e-3)
                 for n, a, b in zip(names, grads, p_grads)}
    worst = max(grad_errs, key=grad_errs.get)
    print(f"train step vs plain step: metrics max rel err {loss_err:.3e} (tol {TOL_LOSS}), "
          f"gradients max err {grad_errs[worst]:.3e} at {worst} (tol {TOL_GRAD})", flush=True)
    require(loss_err <= TOL_LOSS, "train metrics disagree with the plain step")
    require(grad_errs[worst] <= TOL_GRAD, "gradients disagree with the plain step")
    pb = {k: v.detach() for k, v in plain.student.named_buffers()}
    bn_err = max(float((v - pb[k]).abs().max()) for k, v in state.student.named_buffers())
    print(f"train step vs plain step: BatchNorm running stats max abs err {bn_err:.3e}",
          flush=True)
    require(bn_err <= TOL_LOSS, "BatchNorm running statistics disagree with the plain step")

    _, grads2 = run(fresh(True))
    same = all(torch.equal(a, b) for a, b in zip(grads, grads2))
    print(f"train step rerun from the same state: gradients bitwise equal: {same}", flush=True)
    require(same, "the kernel step's gradients are not bitwise repeatable")

    losses = [metrics["loss"]]
    for i in range(3):
        losses.append(run(state, seed=8 + i)[0]["loss"])
    print(f"train step losses over {len(losses)} steps: {losses}", flush=True)
    require(all(math.isfinite(v) for v in losses), "non-finite loss")

    gen_t = torch.Generator(device="cuda").manual_seed(11)
    torch.cuda.reset_peak_memory_stats()
    step_ms = time_ms(lambda: step(state, batch, gen_t), iters=10, warmup=2)
    peak = torch.cuda.max_memory_allocated()
    plain_ms = time_ms(lambda: step(plain, batch, gen_t), iters=3, warmup=1)
    report["train"] = dict(launches=launches, metrics=metrics, plain_metrics=p_metrics,
                           metric_rel_err=loss_err, grad_errs=grad_errs, bn_err=bn_err,
                           bitwise_repeat=same, losses=losses, step_ms=step_ms,
                           clips_per_s=TRAIN_BATCH / step_ms * 1e3, plain_step_ms=plain_ms,
                           peak_bytes=peak)
    return launches, dict(cfg=cfg, tx=tx, sched=sched, batch=batch, init=init)


def train_bf16(ctx, report):
    """Phase 8b: bench.py's bf16 train step (crnn_2024(compute_dtype=bf16),
    MelConfig(compute_dtype="bfloat16")) on the card, from phase 7's weights
    and batch; then, without the random parts and on BF16_CPU_SLOTS clips,
    against the same step through the plain versions on the CPU."""
    import dataclasses

    import torch

    from desed_task_tpu_torch.ops import _build
    from desed_task_tpu_torch.ops.frontend import MelConfig
    from desed_task_tpu_torch.recipes_config import crnn_2024
    from desed_task_tpu_torch.training import create_state, make_train_step

    cfg, tx, sched, batch, init = (ctx[k] for k in ("cfg", "tx", "sched", "batch", "init"))
    mel16 = MelConfig(compute_dtype="bfloat16")
    step = make_train_step(cfg, tx, sched, mel_cfg=mel16)

    def fresh(config, device, bf16=True, **over):
        model = crnn_2024(**({"compute_dtype": torch.bfloat16} if bf16 else {}), **over)
        model.load_state_dict(init)
        return create_state(model, config, tx, device=device)

    def run(state, step_fn, data, device, seed=7):
        metrics = step_fn(state, data, torch.Generator(device=device).manual_seed(seed))
        if device == "cuda":
            torch.cuda.synchronize()
        return ({k: float(v) for k, v in metrics.items()},
                {n: p.grad.detach().float().cpu() for n, p in state.student.named_parameters()})

    state = fresh(cfg, "cuda")
    _build.reset_launches()
    metrics, grads = run(state, step, batch, "cuda")
    launches = dict(_build.LAUNCHES)
    want = {"conv_bn_stats.bf16": 14, "glu_drop_pool.bf16": 14, "bigru": 2,
            "conv_bn_stats_bwd.bf16": 7, "glu_drop_pool_bwd.bf16": 7, "bigru_bwd": 1}
    print(f"train step bf16: launches {launches}, expected {want}", flush=True)
    require(launches == want, "the bf16 train step did not go through every bf16 kernel")
    print("train step bf16 metrics: " + ", ".join(f"{k} {v:.6g}" for k, v in metrics.items()),
          flush=True)
    require(all(math.isfinite(v) for v in metrics.values()), "non-finite bf16 train metrics")
    _, grads2 = run(fresh(cfg, "cuda"), step, batch, "cuda")
    same = all(torch.equal(grads[n], grads2[n]) for n in grads)
    print(f"train step bf16 rerun from the same state: gradients bitwise equal: {same}",
          flush=True)
    require(same, "the bf16 step's gradients are not bitwise repeatable")
    losses = [metrics["loss"]]
    for i in range(3):
        losses.append(run(state, step, batch, "cuda", seed=8 + i)[0]["loss"])
    print(f"train step bf16 losses over {len(losses)} steps: {losses}", flush=True)
    require(all(math.isfinite(v) for v in losses), "non-finite bf16 loss")

    gen_t = torch.Generator(device="cuda").manual_seed(11)
    torch.cuda.reset_peak_memory_stats()
    step_ms = time_ms(lambda: step(state, batch, gen_t), iters=10, warmup=2)
    peak = torch.cuda.max_memory_allocated()

    # the same step without its random parts on BF16_CPU_SLOTS clips: the
    # card, the plain versions on the CPU in bf16 and in fp32
    small = dataclasses.replace(cfg, mixup=None, slots=tuple(
        dataclasses.replace(sl, size=n) for sl, n in zip(cfg.slots, BF16_CPU_SLOTS)))
    part = {sl.name: {k: v[:sl.size] for k, v in batch[sl.name].items()} for sl in small.slots}
    part_cpu = {n: {k: v.cpu() for k, v in d.items()} for n, d in part.items()}
    quiet = dict(dropout=0.0, dropstep_recurrent=0.0)
    step_small = make_train_step(small, tx, sched, mel_cfg=mel16)
    t0 = time.perf_counter()
    _, g_card = run(fresh(small, "cuda", **quiet), step_small, part, "cuda")
    _build.reset_launches()
    _, g_cpu = run(fresh(small, "cpu", **quiet), step_small, part_cpu, "cpu")
    _, g_32 = run(fresh(small, "cpu", bf16=False, **quiet),
                  make_train_step(small, tx, sched), part_cpu, "cpu")
    require(dict(_build.LAUNCHES) == {}, "the CPU steps launched a kernel")
    cpu_s = time.perf_counter() - t0
    shares = {}
    for n in g_cpu:
        if not n.startswith("cnn.") or (n.startswith("cnn.conv") and n.endswith(".bias")):
            continue
        gap = float((g_card[n] - g_cpu[n]).abs().mean())
        precision = float((g_32[n] - g_cpu[n]).abs().mean())
        shares[n] = gap / max(precision, 1e-30)
        print(f"train step bf16 on {small.batch_size} clips (slots {BF16_CPU_SLOTS}, no "
              f"dropout, dropstep or mixup): {n} mean |card - CPU bf16| {gap:.3e}, mean |CPU "
              f"fp32 - CPU bf16| {precision:.3e}, share {shares[n]:.3f} (limit "
              f"{BF16_NEARER:.1f}); max |diff| {float((g_card[n] - g_cpu[n]).abs().max()):.3e} "
              f"against {float((g_32[n] - g_cpu[n]).abs().max()):.3e}", flush=True)
    worst = max(shares, key=shares.get)
    require(shares[worst] < BF16_NEARER,
            f"bf16 step: {worst} is no nearer the CPU's bf16 step than its fp32 step")
    report["train_bf16"] = dict(
        launches=launches, metrics=metrics, bitwise_repeat=same, losses=losses,
        step_ms=step_ms, clips_per_s=TRAIN_BATCH / step_ms * 1e3, peak_bytes=peak,
        reduced=dict(slots=list(BF16_CPU_SLOTS), clips=small.batch_size,
                     random_parts="off (conv dropout 0, dropstep 0, mixup None)"),
        grad_shares=shares, cpu_compare_s=cpu_s)
    return launches


def frontend(gen, pipe, report):
    """Phase 9: the fused log-mel entry point, its kernel against its plain
    version and against the GEMM front-end, and its timings."""
    import torch

    from desed_task_tpu_torch.ops import _build
    from desed_task_tpu_torch.ops.fused_mel import fused_log_mel, fused_log_mel_plain
    from desed_task_tpu_torch.ops.frontend import MelConfig, log_mel_spectrogram
    from desed_task_tpu_torch.ops.median import classwise_median_filter
    from desed_task_tpu_torch.ops.scaler import apply_scaler

    clips = {B: (torch.randn(B, 160000, generator=gen) * 0.1).to("cuda")
             for B in (BATCH, TRAIN_BATCH)}
    _build.reset_launches()
    out = fused_log_mel(clips[BATCH], MelConfig())
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    print(f"front-end: fused_log_mel on {BATCH} clips: launches {launches}", flush=True)
    require(launches == {"fused_log_mel": 1}, "the front-end did not go through its kernel")
    require(tuple(out.shape) == (BATCH, 128, 626) and bool(torch.isfinite(out).all()),
            "fused_log_mel: bad shape or non-finite values")

    plan_fn = _build.function("fused_mel", "fused_log_mel_plan", [_build.I] * 4)
    rows = []
    for B, audio in clips.items():
        for dtype in ("float32", "bfloat16"):
            cfg = MelConfig(compute_dtype=dtype)
            bf16 = dtype == "bfloat16"
            name = "fused_log_mel.bf16" if bf16 else "fused_log_mel"
            plan = plan_fn(cfg.n_fft, cfg.hop_length, cfg.n_mels, int(bf16))
            kernel = MEL_KERNELS.get(plan, "none")
            print(f"fused_log_mel  B={B} {dtype}: plan {plan} ({kernel})", flush=True)
            require(plan == (3 if bf16 else 1), f"fused_log_mel {dtype} took plan {plan}")
            _build.reset_launches()
            got = fused_log_mel(audio, cfg)
            again = fused_log_mel(audio, cfg)
            require(dict(_build.LAUNCHES) == {name: 2},
                    "fused_log_mel did not launch once per call")
            plain = fused_log_mel_plain(audio, cfg)
            gemm = log_mel_spectrogram(audio, cfg)
            require(dict(_build.LAUNCHES) == {name: 2},
                    "a plain front-end launched a kernel")
            err, abs_err = rel_err(got, plain), float((got - plain).abs().max())
            gemm_db = float((got - gemm).abs().max())
            same = torch.equal(got, again)
            if dtype == "float32":
                tol_plain, tol_gemm, ok = TOL_KERNEL, TOL_MEL_FP32_DB, err <= TOL_KERNEL
            else:
                tol_plain, tol_gemm, ok = TOL_MEL_BF16_DB, TOL_MEL_BF16_DB, abs_err <= TOL_MEL_BF16_DB
            print(f"fused_log_mel  B={B} {dtype}: against plain max err {err:.3e} relative, "
                  f"{abs_err:.3e} dB (tol {tol_plain}); against the GEMM front-end "
                  f"{gemm_db:.3e} dB (tol {tol_gemm}); rerun bitwise equal: {same}", flush=True)
            require(ok, "fused_log_mel disagrees with its plain version")
            require(gemm_db <= tol_gemm, "fused_log_mel disagrees with the GEMM front-end")
            require(same, "fused_log_mel is not bitwise repeatable")
            T, nf, nm = got.shape[2], cfg.n_freqs, cfg.n_mels
            flops = 2 * B * T * cfg.n_fft * 2 * nf + 2 * B * T * nf * nm + 4 * B * T * nf
            esize = 2 if dtype == "bfloat16" else 4
            n_bytes = 4 * audio.numel() + esize * (cfg.n_fft * 2 * nf + nf * nm) + 4 * got.numel()
            peak = PEAK_BF16_FLOPS if dtype == "bfloat16" else PEAK_FP32_FLOPS
            rows.append(dict(
                B=B, dtype=dtype, plan=plan, kernel=kernel, max_abs_err=abs_err, rel_err=err,
                gemm_db=gemm_db,
                ms=time_ms(lambda: fused_log_mel(audio, cfg)),
                plain_ms=time_ms(lambda: fused_log_mel_plain(audio, cfg), iters=3),
                yardstick_ms=time_ms(lambda: log_mel_spectrogram(audio, cfg)),
                bound=bound_ms(n_bytes, flops, peak), gflop=flops / 1e9))
            del got, again, plain, gemm

    # the serving scores from fused features against pipe.forward
    audio = clips[BATCH]
    emb = torch.as_tensor(np.random.default_rng(2).standard_normal((BATCH, 768, 496),
                                                                   np.float32), device="cuda")
    with torch.inference_mode():
        strong, weak, _ = pipe.forward(audio, emb)
        x = apply_scaler(fused_log_mel(audio, pipe.mel_cfg), pipe.scaler_cfg, pipe.scaler_state)
        f_strong, f_weak = pipe.model(x, embeddings=emb)
        f_strong = classwise_median_filter(f_strong, pipe.median, class_axis=-2, time_axis=-1)
    s_err = max(float((strong - f_strong).abs().max()), float((weak - f_weak).abs().max()))
    print(f"front-end: serving scores from fused_log_mel features against pipe.forward: "
          f"max err {s_err:.3e} (tol {TOL_SCORES})", flush=True)
    require(s_err <= TOL_SCORES, "scores from the fused front-end disagree")
    report["frontend"] = dict(launches=launches, rows=rows, score_err=s_err)
    return launches, rows


def eval_items(enc, rng):
    """EVAL_CLIPS seeded ten-second clips (int16-valued, as the cache stores
    them), 768x496 embeddings, DESED ground truth as column tables."""
    from desed_task_tpu_torch.utils.classes_dict import CLASSES_DESED

    desed = list(CLASSES_DESED)
    items, rows = [], []
    for i in range(EVAL_CLIPS):
        name = f"eval_{i:03d}.wav"
        events = []
        for _ in range(rng.integers(1, 4)):
            on = round(float(rng.uniform(0, 9)), 3)
            events.append((desed[rng.integers(len(desed))], on,
                           round(min(10.0, on + float(rng.uniform(0.3, 4))), 3)))
        rows += [(name, on, off, lab) for lab, on, off in events]
        audio = np.clip(np.round(rng.standard_normal(160000) * 3277), -32768, 32767) / 32768
        items.append({"audio": audio.astype(np.float32),
                      "labels": enc.encode_strong(events).T.astype(np.float32),
                      "embeddings": rng.standard_normal((768, 496), np.float32),
                      "filename": name})
    gt = {"filename": np.asarray([r[0] for r in rows], object),
          "onset": np.asarray([r[1] for r in rows]), "offset": np.asarray([r[2] for r in rows]),
          "event_label": np.asarray([r[3] for r in rows], object)}
    dur = {"filename": np.asarray([it["filename"] for it in items], object),
           "duration": np.full(EVAL_CLIPS, 10.0)}
    return items, gt, dur


def evaluate(gen, card, report):
    """Phase 10: the eval path (training/evaluate.py) on a DeviceEvalCache."""
    import warnings

    import torch

    from desed_task_tpu_torch.data.device_cache import DeviceEvalCache
    from desed_task_tpu_torch.labels.encoder import ManyHotEncoder
    from desed_task_tpu_torch.ops import _build
    from desed_task_tpu_torch.ops.frontend import MelConfig, log_mel_spectrogram
    from desed_task_tpu_torch.ops.median import classwise_median_filter
    from desed_task_tpu_torch.ops.scaler import ScalerConfig, apply_scaler
    from desed_task_tpu_torch.recipes_config import MEDIAN_2024, crnn_2024
    from desed_task_tpu_torch.training.evaluate import SEDValidator, predict_dataset, run_test
    from desed_task_tpu_torch.training.mean_teacher import MeanTeacherState, make_predict_step
    from desed_task_tpu_torch.utils.classes_dict import CLASSES_DESED, CLASSES_MAESTRO_REAL

    t_phase = time.perf_counter()
    classes = list(CLASSES_DESED) + [c for c in CLASSES_MAESTRO_REAL if c not in CLASSES_DESED]
    enc = ManyHotEncoder(classes, 10, 2048, 256, 4, 16000)
    items, gt, dur = eval_items(enc, np.random.default_rng(3))
    student, teacher = randomize(crnn_2024(), gen), randomize(crnn_2024(), gen)

    def make_state(**over):
        s, t = crnn_2024(**over), crnn_2024(**over)
        s.load_state_dict(student.state_dict())
        t.load_state_dict(teacher.state_dict())
        return MeanTeacherState(step=0, student=s.cuda().eval(), teacher=t.cuda().eval(),
                                opt_state={})

    state, plain = make_state(), make_state(fused_blocks=False, rnn_kernel=False)
    cache = DeviceEvalCache(items, EVAL_BATCH)
    cache.upload()
    n_batches = cache.n_pad // EVAL_BATCH
    predict = make_predict_step()
    validator = SEDValidator(predict, enc, weak_set=cache, synth_set=cache, synth_gt=gt,
                             synth_dur=dur, batch_size=EVAL_BATCH, median_filter=MEDIAN_2024,
                             obj_metric_synth_type="intersection", trajectory_psds=50)
    test_kw = dict(batch_size=EVAL_BATCH, n_thresholds=50, median_filter=MEDIAN_2024)

    def run(st, pred=predict):
        _build.reset_launches()
        t0 = time.perf_counter()
        v = validator(st, 0) if pred is predict else None
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        r = run_test(pred, st, cache, enc, gt, dur, **test_kw)
        t2 = time.perf_counter()
        return v, r, dict(_build.LAUNCHES), t1 - t0, t2 - t1

    (obj, scalars), res, launches, val_s, test_s = run(state)
    # the validator: weak and synth sets, student and teacher (4 passes);
    # run_test: 1 pass
    passes = 5 * n_batches
    want = {"conv_bn_stats": 7 * passes, "glu_drop_pool": 7 * passes, "bigru": passes}
    print(f"eval: {EVAL_CLIPS} clips in a DeviceEvalCache of {n_batches} batches of "
          f"{EVAL_BATCH}; SEDValidator (weak + synth, student + teacher) and run_test: "
          f"launches {launches}, expected {want}", flush=True)
    require(launches == want, "the eval path did not go through every kernel")
    _, p_res, p_launches, _, _ = run(plain)
    require(p_launches == {}, "the plain model's eval launched a kernel")

    names = [it["filename"][:-4] for it in items]
    post = np.stack([res["scores_postprocessed"][k].values for k in names])
    post_p = np.stack([p_res["scores_postprocessed"][k].values for k in names])
    require(post.shape == (EVAL_CLIPS, 156, 27) and bool(np.isfinite(post).all()),
            "eval: bad shape or non-finite scores")
    s_err = float(np.abs(post - post_p).max())
    flips = (post > 0.5) != (post_p > 0.5)
    near = bool((np.abs(post_p[flips] - 0.5) <= TOL_SCORES).all())
    print(f"eval: median-filtered scores against the plain model's: max err {s_err:.3e} "
          f"(tol {TOL_SCORES}); frames whose activity at 0.5 differs: {int(flips.sum())}, "
          f"each within {TOL_SCORES} of 0.5: {near}", flush=True)
    require(s_err <= TOL_SCORES, "eval scores disagree with the plain model's")
    require(near, "an event at 0.5 differs from the plain model's away from the threshold")
    if not flips.any():
        t05, p05 = res["prediction_dfs"][0.5], p_res["prediction_dfs"][0.5]
        require(all(list(t05[c]) == list(p05[c]) for c in t05),
                "the events at 0.5 differ from the plain model's")

    # raw and weak scores: the cache's loop against the plain model's and
    # against the same model over the host-dataset branch
    kw = dict(median_filter=MEDIAN_2024, as_arrays=True, want_events=False)
    c_raw, c_post, _, c_weak, _ = predict_dataset(predict, state.student, cache, enc, EVAL_BATCH,
                                                  **kw)
    h_raw, h_post, _, h_weak, _ = predict_dataset(predict, state.student, items, enc, EVAL_BATCH,
                                                  **kw)
    p_raw, _, _, p_weak, _ = predict_dataset(predict, plain.student, cache, enc, EVAL_BATCH, **kw)
    raw = lambda d: np.stack([d[k].values for k in names])
    raw_err = max(float(np.abs(raw(c_raw) - raw(p_raw)).max()),
                  float(np.abs(c_weak - p_weak).max()))
    same_host = (np.array_equal(raw(c_raw), raw(h_raw)) and np.array_equal(raw(c_post), raw(h_post))
                 and np.array_equal(c_weak, h_weak))
    print(f"eval: raw strong and weak scores against the plain model's: max err {raw_err:.3e} "
          f"(tol {TOL_SCORES}); the cache's scores equal the host-dataset branch's: {same_host}",
          flush=True)
    require(raw_err <= TOL_SCORES, "eval raw scores disagree with the plain model's")
    require(same_host, "the cache's scores differ from the host-dataset branch's")

    numbers = {k: v for k, v in res.items() if k not in ("scores_postprocessed", "prediction_dfs")}
    metrics = {**{k: v for k, v in scalars.items() if not k.endswith("obj_metric")}, **numbers}
    print(f"[{card}] eval metrics (random weights): "
          + ", ".join(f"{k} {v:.6f}" for k, v in sorted(metrics.items())), flush=True)
    require(len(metrics) == 12 and all(math.isfinite(v) and 0 <= v <= 1
                                       for v in metrics.values()),
            "an eval metric is not finite or not in [0, 1]")
    p_metrics = {k: v for k, v in p_res.items() if k in numbers}
    print(f"eval: plain model's run_test metrics: "
          + ", ".join(f"{k} {v:.6f}" for k, v in sorted(p_metrics.items())), flush=True)

    # bf16: run_test on crnn_2024(compute_dtype=bf16) with the bf16 front-end
    mel16 = MelConfig(compute_dtype="bfloat16")
    state16 = make_state(compute_dtype=torch.bfloat16)
    _, res16, launches16, _, test16_s = run(state16, make_predict_step(mel16))
    want16 = {"conv_bn_stats.bf16": 7 * n_batches, "glu_drop_pool.bf16": 7 * n_batches,
              "bigru": n_batches}
    print(f"eval bf16: run_test launches {launches16}, expected {want16}", flush=True)
    require(launches16 == want16, "the bf16 eval did not go through every bf16 kernel")
    post16 = np.stack([res16["scores_postprocessed"][k].values for k in names])
    require(bool(np.isfinite(post16).all()) and all(
        math.isfinite(v) and 0 <= v <= 1 for k, v in res16.items() if k in numbers),
        "bf16 eval: non-finite scores or a metric outside [0, 1]")
    # on N_CPU_CLIPS clips, from the card's bf16 features, the median-filtered
    # scores nearer the same bf16 CRNN through the plain versions on the CPU
    # than the fp32 run's (the limit of phase 4b)
    cpu16 = crnn_2024(compute_dtype=torch.bfloat16)
    cpu16.load_state_dict(student.state_dict())
    cpu16.eval()
    audio = torch.as_tensor(np.stack([it["audio"] for it in items[:N_CPU_CLIPS]]), device="cuda")
    emb = np.stack([it["embeddings"] for it in items[:N_CPU_CLIPS]])
    with torch.inference_mode():
        feats = apply_scaler(log_mel_spectrogram(audio, mel16), ScalerConfig()).cpu()
        s_cpu = classwise_median_filter(cpu16(feats, embeddings=torch.from_numpy(emb))[0],
                                        MEDIAN_2024, class_axis=-2).float().numpy()
    card16 = post16[:N_CPU_CLIPS].transpose(0, 2, 1)
    gap_cpu = float(np.abs(card16 - s_cpu).max())
    gap_fp32 = float(np.abs(card16 - post[:N_CPU_CLIPS].transpose(0, 2, 1)).max())
    share = gap_cpu / max(gap_fp32, 1e-30)
    print(f"eval bf16 on {N_CPU_CLIPS} clips: scores max |diff| {gap_cpu:.3e} from the plain "
          f"bf16 CRNN on the CPU, {gap_fp32:.3e} from the fp32 run (share {share:.3f}, "
          f"limit {BF16_NEARER:.1f})", flush=True)
    require(gap_fp32 > 0 and share < BF16_NEARER,
            "bf16 eval scores are no nearer the plain bf16 forward than the fp32 ones")

    # the forward alone: the cache's loop with no fetch, and no host
    # synchronisation inside it
    def loop():
        outs = []
        for start in range(0, cache.n_pad, EVAL_BATCH):
            audio_b, emb_b = cache.batch(start)
            strong, weak = predict(state.student, audio_b, embeddings=emb_b)
            outs.append((classwise_median_filter(strong, MEDIAN_2024, class_axis=-2), weak))
        return outs

    def syncs_in(fn):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                fn()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        return [str(w.message) for w in caught if "called a synchronizing" in str(w.message)]

    loop()
    torch.cuda.synchronize()
    syncs = syncs_in(loop)
    control = syncs_in(lambda: torch.ones(1, device="cuda").item())
    print(f"eval: host synchronisations inside the cache's loop: {len(syncs)}"
          + (f" (first: {syncs[0][:200]})" if syncs else "")
          + f"; a .item() in the same watch: {len(control)}", flush=True)
    require(len(control) == 1, "the synchronisation watch does not see a .item()")
    require(not syncs, "the cache's loop synchronises with the host")
    fwd_ms = time_ms(loop, iters=5, warmup=1)
    plain_fwd_ms = time_ms(lambda: predict_dataset(predict, plain.student, cache, enc, EVAL_BATCH,
                                                   want_raw=False, want_post=False,
                                                   want_events=False), iters=2, warmup=1)
    t_val = time.perf_counter()
    validator(state, 1)
    val2_s = time.perf_counter() - t_val
    phase_s = time.perf_counter() - t_phase
    print(f"[{card}] eval forward alone ({EVAL_CLIPS} clips, {n_batches} batches of "
          f"{EVAL_BATCH}, median filter on the card): {fwd_ms:.3f} ms, "
          f"{EVAL_CLIPS / fwd_ms * 1e3:.1f} clips/s (plain model, with the fetch: "
          f"{plain_fwd_ms:.3f} ms)", flush=True)
    print(f"[{card}] eval wall time: SEDValidator pass {val_s:.3f} s (again: {val2_s:.3f} s), "
          f"run_test {test_s:.3f} s, bf16 run_test {test16_s:.3f} s; phase 10 {phase_s:.1f} s",
          flush=True)
    report["eval"] = dict(clips=EVAL_CLIPS, batches=n_batches, launches=launches,
                          launches_bf16=launches16, score_err=s_err, raw_err=raw_err,
                          flips_at_05=int(flips.sum()), same_as_host=same_host, metrics=metrics,
                          plain_metrics=p_metrics, bf16_share=share, forward_ms=fwd_ms,
                          clips_per_s=EVAL_CLIPS / fwd_ms * 1e3, validator_s=val_s,
                          validator_again_s=val2_s, run_test_s=test_s, run_test_bf16_s=test16_s,
                          phase_s=phase_s)
    return launches, launches16


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (ROOT / "desed_task_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: desed_task_tpu_torch/ not found beside this script", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    print(f"card: {card}", flush=True)
    report = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda}

    from desed_task_tpu_torch.ops import _build
    from desed_task_tpu_torch.ops.frontend import MelConfig
    from desed_task_tpu_torch.recipes_config import crnn_2024

    t0 = time.perf_counter()
    libs = _build.build_all()
    for name in libs:
        _build.load(name)
    report["build_s"] = time.perf_counter() - t0
    print(f"build: {sorted(libs)} in {report['build_s']:.1f} s", flush=True)

    gen = torch.Generator().manual_seed(0)
    geoms = block_geometries(crnn_2024(), MelConfig(), 160000)
    rows = check_kernels(geoms, gen, report)
    rows.update(check_kernels_bf16(geoms, gen, report, rows))
    serve_launches, pipe, serve16_launches = serve(gen, report)
    train_geoms = block_geometries(crnn_2024(), MelConfig(), 160000)
    rows.update(check_bwd_kernels(train_geoms, gen, report))
    rows.update(check_bwd_kernels_bf16(train_geoms, gen, report, rows))
    train_launches, train_ctx = train(gen, report)
    train16_launches = train_bf16(train_ctx, report)
    fe_launches, fe_rows = frontend(gen, pipe, report)
    eval_launches, eval16_launches = evaluate(gen, card, report)
    # the kernels line's row 7: calls at B=64, fp32 and (its own entry) bf16
    rows["fused_log_mel"] = [r for r in fe_rows if r["B"] == BATCH and r["dtype"] == "float32"]
    rows["fused_log_mel.bf16"] = [r for r in fe_rows
                                  if r["B"] == BATCH and r["dtype"] == "bfloat16"]

    fw = report["forward"]
    print(f"[{card}] device forward, batch {BATCH}: {fw['forward_ms']:.3f} ms "
          f"(plain versions {fw['plain_forward_ms']:.3f} ms; front-end + scaler "
          f"{fw['frontend_ms']:.3f} ms, CRNN {fw['model_ms']:.3f} ms)", flush=True)
    fb = report["forward_bf16"]
    print(f"[{card}] device forward bf16, batch {BATCH}: {fb['forward_ms']:.3f} ms "
          f"(front-end + scaler {fb['frontend_ms']:.3f} ms, CRNN {fb['model_ms']:.3f} ms; "
          f"fp32 {fw['forward_ms']:.3f} / {fw['frontend_ms']:.3f} / {fw['model_ms']:.3f} ms)",
          flush=True)
    tr = report["train"]
    print(f"[{card}] train step, {TRAIN_BATCH} clips, fp32: {tr['step_ms']:.3f} ms "
          f"({tr['clips_per_s']:.1f} clips/s; plain versions {tr['plain_step_ms']:.3f} ms; "
          f"peak memory {tr['peak_bytes'] / 2**30:.2f} GiB)", flush=True)
    t16 = report["train_bf16"]
    print(f"[{card}] train step, {TRAIN_BATCH} clips, bf16: {t16['step_ms']:.3f} ms "
          f"({t16['clips_per_s']:.1f} clips/s; peak memory {t16['peak_bytes'] / 2**30:.2f} GiB; "
          f"fp32 {tr['step_ms']:.3f} ms, {tr['clips_per_s']:.1f} clips/s)", flush=True)
    for r in fe_rows:
        b_ms, by = r["bound"]
        print(f"[{card}] fused_log_mel B={r['B']} {r['dtype']} (plan {r['plan']}, "
              f"{r['kernel']}): {r['ms']:.3f} ms per call "
              f"({r['gflop']:.1f} GFLOP), bound {b_ms:.3f} ms ({by}), plain "
              f"{r['plain_ms']:.3f} ms, GEMM front-end (yardstick) {r['yardstick_ms']:.3f} ms",
              flush=True)
    cnn_cu, gru_cu = "desed_task_tpu_torch/csrc/fused_cnn.cu", "desed_task_tpu_torch/csrc/gru.cu"
    sources = {
        "conv_bn_stats": (cnn_cu, "desed_task_tpu/ops/pallas_cnn.py:147"),
        "glu_drop_pool": (cnn_cu, "desed_task_tpu/ops/pallas_cnn.py:269"),
        "conv_bn_stats.bf16": (cnn_cu, "desed_task_tpu/ops/pallas_cnn.py:147 (bf16 mode)"),
        "glu_drop_pool.bf16": (cnn_cu, "desed_task_tpu/ops/pallas_cnn.py:269 (bf16 mode)"),
        "bigru": (gru_cu, "desed_task_tpu/ops/pallas_gru.py:38"),
        "conv_bn_stats_bwd": (cnn_cu, "desed_task_tpu/ops/pallas_cnn.py:186"),
        "glu_drop_pool_bwd": (cnn_cu, "desed_task_tpu/ops/pallas_cnn.py:295"),
        "conv_bn_stats_bwd.bf16": (cnn_cu, "desed_task_tpu/ops/pallas_cnn.py:186 (bf16 mode)"),
        "glu_drop_pool_bwd.bf16": (cnn_cu, "desed_task_tpu/ops/pallas_cnn.py:295 (bf16 mode)"),
        "bigru_bwd": (gru_cu, "desed_task_tpu/ops/pallas_gru.py:58"),
        "fused_log_mel": ("desed_task_tpu_torch/csrc/fused_mel.cu",
                          "desed_task_tpu/ops/pallas_mel.py:96"),
        "fused_log_mel.bf16": ("desed_task_tpu_torch/csrc/fused_mel.cu",
                               "desed_task_tpu/ops/pallas_mel.py:96 (bf16 mode)"),
    }
    kernels = []
    for name, rs in rows.items():
        lib = [r.get("library_ms") for r in rs]
        b_ms = sum(r["bound"][0] for r in rs)
        by_ops = sum(r["bound"][0] for r in rs if r["bound"][1] == "operations")
        by_path = {"serving": serve_launches.get(name, 0),
                   "serving_bf16": serve16_launches.get(name, 0),
                   "train_step": train_launches.get(name, 0),
                   "train_step_bf16": train16_launches.get(name, 0),
                   "frontend": fe_launches.get(name, 0),
                   "eval": eval_launches.get(name, 0),
                   "eval_bf16": eval16_launches.get(name, 0)}
        main_path = ("frontend" if name.startswith("fused_log_mel")
                     else "train_step_bf16" if name.endswith("_bwd.bf16")
                     else "serving_bf16" if name.endswith(".bf16") else "train_step")
        entry = dict(
            name=name, route="cuda", source=sources[name][0], replaces=sources[name][1],
            launches=by_path[main_path],
            max_abs_err=max(r["max_abs_err"] for r in rs),
            ms=sum(r["ms"] for r in rs), plain_ms=sum(r["plain_ms"] for r in rs),
            bound_ms=b_ms, bound_by="operations" if by_ops >= b_ms / 2 else "bytes",
            library_ms=None if None in lib else sum(lib), launches_by_path=by_path,
        )
        if name in ("bigru", "bigru_bwd"):
            r0 = rs[0]
            entry.update(plan=r0["plan"], C=r0["C"], BT=r0["BT"],
                         us_per_step=r0["ms"] / r0["steps"] * 1e3)
        if name.startswith("fused_log_mel"):
            entry.update(plan=rs[0]["plan"], kernel=rs[0]["kernel"])
            entry["yardstick_ms"] = rs[0]["yardstick_ms"]
            entry["yardstick"] = ("log_mel_spectrogram, the GEMM front-end (several "
                                  "calls: no single PyTorch call computes this function)")
        kernels.append(entry)
        lib_s = "n/a" if entry["library_ms"] is None else f"{entry['library_ms']:.3f} ms"
        if name.startswith("fused_log_mel"):
            per = f"per call ({len(rs)} call at B={BATCH}, {rs[0]['dtype']})"
        elif name in serve_launches or name in serve16_launches:
            per = f"per forward ({len(rs)} call(s) at B={BATCH})"
        else:
            per = f"per train step ({len(rs)} call(s) at B={TRAIN_BATCH})"
        gru_s = (f", {entry['plan']} C={entry['C']} BT={entry['BT']}, "
                 f"{entry['us_per_step']:.2f} us/step" if "C" in entry else "")
        print(f"[{card}] {name}: {entry['ms']:.3f} ms {per}, bound {b_ms:.3f} ms "
              f"({entry['bound_by']}), plain {entry['plain_ms']:.3f} ms, "
              f"library {lib_s}{gru_s}", flush=True)
    report["kernels"] = kernels
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
