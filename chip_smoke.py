#!/usr/bin/env python3
"""Start the PyTorch port on one NVIDIA GPU and hold it to its plain versions.

    python3 chip_smoke.py [--phases 3,4,6,7,8b,9,10,11,12,13,14,15]

With no argument every phase runs (what the contract runs). `--phases`
runs the build and the phases named (each with its lettered sub-phases),
and the phases they take their context from (8b and 14 need 7, 9 needs 4);
the kernels line then holds the rows that ran, and the last line is the
same.

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
     wall time of a validator pass and of run_test;
  11. the 2024 recipe (training/single_run.py) on a seeded corpus of 202
     ten-second PCM16 clips (MAESTRO 5 scenes x 3 files x 3 windows and 10
     validation windows; synth 12, strong 12, weak 27, unlabeled 48,
     synth_val 24, test 24), a float16 768x496 frame-embedding store per
     split (HDF5 where h5py can be imported, else InMemoryEmbeddings, said
     on a line of its own), the conf of year_config() on pretrained.yaml
     (at full width, only the data paths changed; every step's metrics
     logged): run (a), bf16 (the CLI's default), fast_dev_run: 2 epochs of
     2 steps through the device train store, validation each epoch
     (student and teacher: weak, synth and MAESTRO sets from eval caches),
     best and last checkpoints, the test battery at 2 thresholds with
     MAESTRO; launches exactly those of phase 8b a step and 7/7/1 a batch
     per model pass, metrics.csv names RECIPE_NAMES (and the step's), 4
     finite losses, metrics in [0, 1]; the best checkpoint into a fresh
     state bitwise (state dicts, Adam moments, the generator); a gathered
     batch and a cached step bitwise equal to the host path's from a copy
     of the state; one more epoch through the loop with one blocking host
     synchronisation a step; the label-free eval dump from run (a)'s
     checkpoint (a score file a clip); run (b), fp32, the test battery
     from run (a)'s best checkpoint (launches 7/7/1 a batch), its first
     test batch's scores within TOL_RECIPE of the plain versions' on the
     restored weights and equal to a recomputation; timings of each epoch
     (train seconds, steps/s, busy share), validation pass and test
     battery, the store's upload, the analytic MMACs and the energy
     estimate's range;
  12. the 2021-2023 recipes: first the fine-tune's kernels at its shapes,
     the fused conv block of crnn_2023() in eval-mode BatchNorm with
     gradients (the multisrc CRNN's freeze_bn) at B=384 (96 clips x 4
     sources), forward and backward, and the 2-layer H=128 BiGRU (cluster
     plan, ragged last CTA) at B=96 and 384, each against the plain
     versions within TOL_KERNEL, bitwise reruns; then, on a seeded corpus
     of 159 ten-second PCM16 clips (YEAR_CLIPS; a float16 768x1214 AST
     frame-embedding store per split) and the year confs of year_config()
     (the yaml files, only data.* changed), through the entry points:
     (a) dcase2023_train_sed --fast_dev_run --strong_real (default.yaml,
     bf16), (b) dcase2022_train_pretrained on pretrained_ast.yaml (the
     frame BiGRU at H=512: the stream kernels at B=96, T=1214), each with
     its launches read around each train step of the run (StepLaunches)
     and an eval batch's from the rest, each equal to the model's count
     (YEAR_STEP16 / AST_STEP16 a step, YEAR_EVAL16 / AST_EVAL16 an eval
     batch), and its test metrics finite in [0, 1];
     (c) dcase2021_pretrain_separation, TDCNPP() at full width, 2 epochs of
     2 steps of 16 four-second segments with SI-SNRi, no kernel launched;
     the separator on a ten-second clip against its CPU forward within
     TOL_SEP, with the process allowing TF32 (PyTorch's default for
     cuDNN; the separator keeps it off itself); (d) dcase2021_run_separation --backend torch over the
     corpus's folders; (e) dcase2021_finetune_on_separated --fast_dev_run
     from (a)'s checkpoint with the test battery (launches read as in
     (a): FINETUNE_STEP a step, FINETUNE_EVAL an eval batch); then one fine-tune step on a
     host batch of 96 clips x 4 sources: its launches exact, its metrics
     and gradients against the plain-version step, a bitwise rerun, its ms,
     the plain step's, the host batch's read and collate time, and 3
     loop epochs on host batches from 6 workers with their busy share;
  13. the embedders at full width on seeded weights written as facsimiles
     of the released files and loaded through the released-layout loaders
     (`build_embedder`): (a) BEATs on 60 ten-second clips (frame [60, 768,
     496]), its forward on N_CMP clips within TOL_EMB of the same module on
     the CPU with TF32 allowed in the process, ms and bound; (b) Cnn14_16k
     on 16 clips ([16, 2048, 125]) and AST on 8 spectrograms ([8, 768,
     1214]), held the same way (AST on the same fbank on both sides); (c)
     `extract_splits` over two folders of seeded wavs and an empty one (the
     h5py seam: MemoryH5 where h5py cannot be imported, said on a line),
     rows within TOL_STORE of the forward of the same batches, the float16
     stores equal to the fp32 stores' cast, then the 2024 recipe's corpus
     extracted (float16) and single_run (fast_dev_run, bf16) trained from
     those stores; (d) the 2024 train step with BEATs inside
     (`embedder=frame_embedder(beats)`, the batch without embeddings), fp32
     and bf16: launches STEP_LAUNCHES / STEP16_LAUNCHES, gradients bitwise
     on a rerun, BEATs' weights bitwise unchanged, the fp32 step within
     TOL_LOSS / TOL_GRAD of the plain step, step ms; (e) serving the 130
     wavs with BEATs inside the forward: 7/7/1 a batch, scores within
     TOL_SCORES of the plain forward; (f) pretrain_beats at the full config
     (batch 8, PRETRAIN_STEPS steps, 32 wavs: finite losses, 298 of 496
     tokens masked a clip, step ms), finetune_beats_weak 2 steps, the saved
     file loaded through build_embedder;
  14. parallelism (desed_task_tpu_torch/parallel): (a) in this process,
     one NCCL rank: make_train_step_sharded on {"data": 1} from phase 8's
     state and batch bitwise equal to make_train_step over 2 steps
     (metrics, gradients, student, teacher, BN statistics, Adam moments);
     then PAR_RANKS gloo ranks sharing cuda:0 (NCCL refuses two ranks on
     one device; one spawn, joined within 120 s): (b) the 2024 step on 30
     clips a rank, fp32 and bf16, 2 steps: each rank's launches a step
     STEP_LAUNCHES / STEP16_LAUNCHES, replicas bitwise equal after each
     step, the fp32 step without dropout, dropstep or mixup within TOL_LOSS
     / TOL_GRAD of the same 2-rank step through the plain versions; step
     ms, the three all-reduces' bytes and ms; (c) phase 10's 96 clips in a
     cache row-sharded over the ranks, gathered to rank 0 bitwise equal to
     the single-card cache's scores, 7/7/1 a batch a model pass on each
     rank; (d) BEATsConfig() tensor-parallel over (data=1, model=2) on
     phase 13's seeded weights, within TOL_TP of the full forward on
     TP_CLIPS clips, and the e2e fp32 step with it inside (launches
     STEP_LAUNCHES) within TOL_LOSS / TOL_GRAD of the same step with the
     full BEATs from the same state; (e) single_run fast_dev_run (bf16) on
     phase 11's corpus on both ranks: 4 finite losses, replicas equal,
     rank 0 alone writes and tests, the best checkpoint reloads bitwise.
     Two ranks on one card measure correctness and the collectives' cost,
     not scaling;
  15. the auxiliaries: (a) the quickstart (recipes/quickstart_synthetic)
     on the card: its tone soundbank and QS_TRAIN training soundscapes (and
     the other splits) from its seeds, one epoch through single_run (bf16,
     its default) with every step's loss logged: each step's launches those
     of phase 8b's step with the GRU kernels twice (QS_STEP: two GRU
     layers), finite losses,
     test metrics in [0, 1]; then QS_TRACED_STEPS more steps of its loop
     under obs/profiling.trace and a StepTimer (one sync at its cadence):
     the Chrome trace names, for each of rows 1-6, a hand-written kernel
     launched inside its custom op or autograd node; the timer's stats;
     (b) tools/hpo.run_study with HPO_TRIALS trials and 2 workers, both
     pinned to the card (CUDA_VISIBLE_DEVICES=0), the objective
     `hpo_objective` (single_run fast_dev_run, bf16, on (a)'s corpus):
     both records written, every trial's objective run was on the card and
     launched every kernel of a bf16 step (the workers claim trials
     first-come, so one of them may run both),
     each trial's parameters equal to the same seed's drawn on the CPU; the
     study's seconds; (c) crnn_2024() serving (768x496 embeddings,
     MEDIAN_2024, 50 thresholds) exported through tools/export.py at batch
     64 and loaded: the graph calls the three custom ops (7 + 7 + 1), the
     loaded program launches 7/7/1 a batch and its outputs on 64 seeded
     clips are bitwise equal to the eager pipeline's; the same for the
     bf16 pipeline (rows 1b, 2b, 5); exported and eager forward ms.
Then a `kernels` JSON line (rows 5 and 6 with their plan, cluster size C,
batch rows BT and us per recurrence step; the bf16 modes of rows 1 and 2 as
entries of their own, launches from the bf16 serving run, and of rows 3 and
4, launches from the bf16 train step; `launches_by_path` with each path's
counts, "eval" and "eval_bf16" among them, and "recipe" and
"recipe_bf16", each {"train_step": launches a train step, "eval_batch":
launches an eval batch per model pass} from phase 11, and "recipe_2023_bf16",
"recipe_2022_ast_bf16" and "finetune" the same from phase 12, "e2e_beats" and
"e2e_beats_bf16" (launches a step) and "serve_beats" (a batch) from phase 13,
"sharded_step", "sharded_step_bf16" and "tp_e2e_beats" (rank 0's launches a
step) and "sharded_eval" (a batch a model pass) from phase 14, "quickstart"
(launches a step), "hpo" (both workers' runs) and "export" (a batch of the
loaded fp32 and bf16 programs) from phase 15;
row 7 in fp32 and, as `fused_log_mel.bf16`, in bf16, each at B=64 with its plan, launched on no
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
# launches of one 2024 train step (phases 8 and 8b, and 13's e2e step)
STEP_LAUNCHES = {"conv_bn_stats": 14, "glu_drop_pool": 14, "bigru": 2,
                 "conv_bn_stats_bwd": 7, "glu_drop_pool_bwd": 7, "bigru_bwd": 1}
STEP16_LAUNCHES = {"conv_bn_stats.bf16": 14, "glu_drop_pool.bf16": 14, "bigru": 2,
                   "conv_bn_stats_bwd.bf16": 7, "glu_drop_pool_bwd.bf16": 7, "bigru_bwd": 1}
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


def train_batch(cfg, rng, embeddings: bool = True) -> dict:
    """A seeded global batch of `cfg`'s slots as numpy arrays: ten-second
    clips, labels at 5 %, 768x496 embeddings (phase 7's with rng seed 1)."""
    batch = {}
    for s in cfg.slots:
        batch[s.name] = {
            "audio": rng.standard_normal((s.size, 160000), np.float32) * 0.05,
            "labels": (rng.random((s.size, 27, 156)) > 0.95).astype(np.float32)}
        if embeddings:
            batch[s.name]["embeddings"] = rng.standard_normal((s.size, 768, 496), np.float32)
        batch[s.name]["class_mask"] = np.ones((s.size, 27), bool)
    return batch


def to_card(batch: dict, dev="cuda") -> dict:
    import torch

    return {k: to_card(v, dev) if isinstance(v, dict) else torch.as_tensor(v, device=dev)
            for k, v in batch.items()}


def train(gen, report):
    """Phases 7 and 8a: the 2024 mean-teacher step on the card."""
    import torch

    from desed_task_tpu_torch.ops import _build
    from desed_task_tpu_torch.recipes_config import crnn_2024, mean_teacher_2024
    from desed_task_tpu_torch.training import create_state, make_optimizer, make_train_step

    cfg = mean_teacher_2024()
    require(cfg.batch_size == TRAIN_BATCH, "mean_teacher_2024() is not 60 clips")
    batch = to_card(train_batch(cfg, np.random.default_rng(1)))
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
    want = STEP_LAUNCHES
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
    want = STEP16_LAUNCHES
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

    loop()
    torch.cuda.synchronize()
    _, syncs = syncs_in(loop)
    _, control = syncs_in(lambda: torch.ones(1, device="cuda").item())
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


# phase 11: the 2024 recipe (training/single_run.py) end to end
RECIPE_SCENES = ("cafe_restaurant", "city_center", "grocery_store", "metro_station",
                 "residential_area")
# clips of each split of the phase's corpus (ten seconds, PCM16, 16 kHz):
# MAESTRO 5 scenes x 3 files x 3 windows (30 train, 15 validate under the
# 0.9 per-scene split), 10 MAESTRO validation windows
RECIPE_CLIPS = dict(synth=12, strong=12, weak=27, unlabeled=48, synth_val=24, test=24)
# the fp32 kernels against their plain versions on the restored weights'
# test scores: the CRNN tests' tolerance
TOL_RECIPE = 2e-6
# epochs of the loop on host batches in phase 11 (2 steps each)
HOST_EPOCHS = 4
# the metrics.csv names of JAX's single_run on this layout with fast_dev_run
# (tests/test_torch_single_run.py holds the list to a JAX run); phase 11
# also logs every step's metrics (training.log_every 1)
RECIPE_NAMES = (
    ["train/epoch", "train/epoch_seconds", "train/steps_per_sec"]
    + [f"val/{s}/{tag}/{m}" for tag in ("student", "teacher")
       for s, m in (("weak", "macro_F1"), ("synth", "intersection_f1_macro"),
                    ("maestro", "segment_f1_best"), ("maestro", "segment_mpauc"))]
    + ["val/teacher/obj_metric", "val/obj_metric", "train/energy_kwh_estimate"]
    + [f"test/student/{m}" for m in ("psds1", "psds2", "intersection_f1_macro",
                                     "event_f1_macro")]
)


def year_config(path: Path, root: Path) -> dict:
    """A recipe conf (yaml) as a dict, every value as there but the data
    paths, which point into `root` (the phase's corpus; strong_folder and
    strong_tsv added, read where --strong_real asks for them; the MAESTRO
    paths where the conf has them; the label-free eval folder is the test
    folder), and the embedding directory."""
    import yaml

    config = yaml.safe_load(Path(path).read_text())
    r = lambda *p: str(root.joinpath(*p))
    config["data"].update(
        synth_folder=r("synth"), synth_tsv=r("meta", "synth.tsv"),
        strong_folder=r("strong"), strong_tsv=r("meta", "strong.tsv"),
        weak_folder=r("weak"), weak_tsv=r("meta", "weak.tsv"),
        unlabeled_folder=r("unlabeled"),
        synth_val_folder=r("synth_val"), synth_val_tsv=r("meta", "synth_val.tsv"),
        synth_val_dur=r("meta", "synth_val_durations.tsv"),
        test_folder=r("test"), test_tsv=r("meta", "test.tsv"),
        test_dur=r("meta", "test_durations.tsv"))
    maestro = dict(
        real_maestro_train_folder=r("maestro_train"),
        real_maestro_train_tsv=r("meta", "maestro_real_train.tsv"),
        real_maestro_val_folder=r("maestro_val"),
        real_maestro_val_tsv=r("meta", "maestro_real_validation.tsv"),
        real_maestro_val_dur=r("meta", "maestro_real_durations.tsv"), eval_folder=r("test"))
    config["data"].update({k: v for k, v in maestro.items() if k in config["data"]})
    if "pretrained" in config:
        config["pretrained"]["extracted_embeddings_dir"] = r("embeddings")
    return config


class InMemoryEmbeddings:
    """The interface of the datasets' HDF5 embedding store (`index`,
    `get(stem)`) over arrays held in this process, keyed by the store's
    path: phases 11 and 12's stand-in where h5py cannot be imported."""

    rows: dict = {}  # path -> {stem: float16 [768, frames]}

    def __init__(self, path, embedding_type):
        self.table = self.rows[str(path)]
        self.index = {stem: i for i, stem in enumerate(self.table)}

    def get(self, stem: str) -> np.ndarray:
        return self.table[stem]


def write_corpus(root: Path, rng, clips: dict, emb_model: str, frames: int,
                 maestro: bool) -> tuple[int, int, bool]:
    """A phase's corpus under `root`: the DESED splits of `clips` (wavs,
    tsv files as csv), with `maestro` also the MAESTRO splits and the
    label-free eval store (the 2024 layout), and one float16 768 x `frames`
    frame-embedding store per split under embeddings/<emb_model>, in HDF5
    where h5py can be imported, else in InMemoryEmbeddings.rows (empty
    placeholder files mark the stores' paths). Returns (clips, wav bytes,
    h5py used)."""
    import csv

    from desed_task_tpu_torch.data.audio_io import write_wav
    from desed_task_tpu_torch.utils.classes_dict import (
        CLASSES_DESED, CLASSES_MAESTRO_REAL, CLASSES_MAESTRO_REAL_EVAL)

    desed, maestro_labels = list(CLASSES_DESED), list(CLASSES_MAESTRO_REAL)
    maestro_eval = sorted(CLASSES_MAESTRO_REAL_EVAL)
    meta = root / "meta"
    meta.mkdir(parents=True)
    stems: dict = {}  # folder -> stems

    def wavs(folder, names):
        (root / folder).mkdir()
        for name in names:
            audio = np.clip(np.round(rng.standard_normal(160000) * 3277), -32768, 32767)
            write_wav(root / folder / name, (audio / 32768).astype(np.float32), 16000)
        stems[folder] = [n[:-4] for n in names]

    def tsv(name, header, rows):
        with open(meta / name, "w", newline="") as f:
            w = csv.writer(f, delimiter="\t", lineterminator="\n")
            w.writerow(header)
            w.writerows(rows)

    def events(names, labels, conf=False, k=(1, 4)):
        """Seeded events; with conf, a confidence each, and a first event
        of every window in MAESTRO's 11 evaluated classes at 0.9, so that
        every validation file has ground truth."""
        rows = []
        for name in names:
            for j in range(rng.integers(*k)):
                on = round(float(rng.uniform(0, 9)), 3)
                off = round(min(10.0, on + float(rng.uniform(0.3, 4))), 3)
                pool = maestro_eval if conf and j == 0 else labels
                row = [name, on, off, pool[rng.integers(len(pool))]]
                c = 0.9 if j == 0 else round(float(rng.uniform(0.2, 1.0)), 3)
                rows.append(row + [c] if conf else row)
        return rows

    head = ["filename", "onset", "offset", "event_label"]
    # the stores single_run reads (training/single_run.py _emb_file)
    splits = dict(synth_train="synth", strong_train="strong", weak_train="weak",
                  unlabeled_train="unlabeled", synth_val="synth_val", devtest="test")
    if maestro:
        m_train = [f"{s}_{f:02d}-{w * 1000:06d}-{w * 1000 + 1000:06d}.wav"
                   for s in RECIPE_SCENES for f in range(3) for w in range(3)]
        m_val = [f"{RECIPE_SCENES[i % 5]}_{10 + i:02d}-000000-001000.wav" for i in range(10)]
        wavs("maestro_train", m_train)
        wavs("maestro_val", m_val)
        tsv("maestro_real_train.tsv", head + ["confidence"],
            events(m_train, maestro_labels, True, (2, 5)))
        tsv("maestro_real_validation.tsv", head + ["confidence"],
            events(m_val, maestro_labels, True))
        tsv("maestro_real_durations.tsv", ["filename", "duration"], [(n, 10.0) for n in m_val])
        splits = dict(maestro_real_train="maestro_train", maestro_real_val="maestro_val",
                      **splits, eval="test")
    for split, n in clips.items():
        names = [f"{split}_{i:03d}.wav" for i in range(n)]
        wavs(split, names)
        if split in ("synth", "strong", "synth_val", "test"):
            tsv(f"{split}.tsv", head, events(names, desed))
        if split in ("synth_val", "test"):
            tsv(f"{split}_durations.tsv", ["filename", "duration"], [(x, 10.0) for x in names])
        if split == "weak":
            tsv("weak.tsv", ["filename", "event_labels"],
                [(x, ",".join(sorted(set(rng.choice(desed, rng.integers(1, 4)))))) for x in names])
    emb_dir = root / "embeddings" / emb_model
    emb_dir.mkdir(parents=True)
    try:
        import h5py
    except ImportError:
        h5py = None
    made = {}
    for split, folder in splits.items():
        if folder not in made:
            made[folder] = {s: rng.standard_normal((768, frames), np.float32).astype(np.float16)
                            for s in stems[folder]}
        path = emb_dir / f"{split}.hdf5"
        if h5py is None:
            path.touch()
            InMemoryEmbeddings.rows[str(path)] = made[folder]
            continue
        with h5py.File(path, "w") as f:
            f["filenames"] = np.asarray([s.encode() for s in made[folder]])
            f["frame_embeddings"] = np.stack(list(made[folder].values()))
    n = sum(len(v) for v in stems.values())
    return n, n * (160000 * 2 + 44), h5py is not None


def syncs_in(fn):
    """Run fn with the CUDA sync debug mode on "warn"; returns (fn's result,
    the messages of the blocking host synchronisations it made)."""
    import warnings

    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, [str(w.message) for w in caught if "called a synchronizing" in str(w.message)]


def recipe(card, report, step16_launches):
    """Phase 11: the 2024 recipe through single_run on the card, bf16 (the
    CLI's default) then fp32 from its checkpoint."""
    import copy
    import csv

    import torch

    from desed_task_tpu_torch.data import datasets
    from desed_task_tpu_torch.data.batcher import MultiSourceBatcher, collate
    from desed_task_tpu_torch.obs.checkpoint import CheckpointManager
    from desed_task_tpu_torch.obs.logging import MetricsLogger
    from desed_task_tpu_torch.obs.macs import forward_macs
    from desed_task_tpu_torch.ops import _build
    from desed_task_tpu_torch.training import create_state, make_optimizer
    from desed_task_tpu_torch.training.evaluate import predict_dataset
    from desed_task_tpu_torch.training.loop import TrainLoop
    from desed_task_tpu_torch.training.single_run import _emb_file, build_model, single_run
    from desed_task_tpu_torch.utils import table as tbl

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="recipe_") as tmp:
        root = Path(tmp)
        t0 = time.perf_counter()
        n_clips, wav_bytes, with_h5py = write_corpus(root, np.random.default_rng(17),
                                                     RECIPE_CLIPS, "beats", 496, maestro=True)
        corpus_s = time.perf_counter() - t0
        if not with_h5py:
            print("embedding store: in-memory stand-in (no h5py here)", flush=True)
            datasets._EmbeddingStore = InMemoryEmbeddings
        print(f"recipe: corpus of {n_clips} ten-second clips ({wav_bytes / 1e6:.1f} MB of "
              f"wavs, 768x496 float16 embeddings each) written in {corpus_s:.2f} s", flush=True)
        config = year_config(ROOT / "recipes" / "dcase2024_task4_baseline" / "confs"
                             / "pretrained.yaml", root)
        config["training"]["log_every"] = 1  # every step's losses in metrics.csv
        bs_val = config["training"]["batch_size_val"]
        batches = lambda n: -(-n // bs_val)

        # run (a): bf16 (the CLI's default), fast_dev_run
        info = {}
        _build.reset_launches()
        t0 = time.perf_counter()
        state, res = single_run(config, str(root / "run_a"), fast_dev_run=True, fast=True,
                                run_info=info)
        run_a_s = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
        cache, loop, batcher = info["cache"], info["loop"], info["batcher"]
        require(cache is not None, "recipe: the device train store did not switch on")
        steps = sum(h["steps"] for h in loop.history)
        vals = sum(h["val_s"] is not None for h in loop.history)
        weak_val = RECIPE_CLIPS["weak"] - int(RECIPE_CLIPS["weak"] * 0.9)
        maestro_val = 5 * (3 - int(3 * 0.9)) * 3  # a file a scene, 3 windows each
        val_batches = batches(weak_val) + batches(RECIPE_CLIPS["synth_val"]) + batches(maestro_val)
        test_batches = batches(RECIPE_CLIPS["test"]) + batches(10)
        evals = 2 * vals * val_batches + test_batches  # student and teacher
        expect_eval16 = {"conv_bn_stats.bf16": 7, "glu_drop_pool.bf16": 7, "bigru": 1}
        want = {k: steps * v + evals * expect_eval16.get(k, 0)
                for k, v in step16_launches.items()}
        print(f"recipe bf16: {steps} steps, {vals} validations, {evals} eval batches (24 a "
              f"batch, per model pass); launches {launches}, expected {want}", flush=True)
        require(steps == 4 and vals == 2, "recipe: not 2 epochs of 2 steps with validation")
        require(launches == want, "recipe: the bf16 run did not launch the expected kernels")
        with open(root / "run_a" / "metrics.csv") as f:
            rows = list(csv.DictReader(f))
        names = list(dict.fromkeys(r["name"] for r in rows))
        step_names = [f"train/{k}" for k in ("loss", "loss_strong", "loss_weak",
                                             "strong_self_sup_loss", "weak_self_sup_loss",
                                             "tot_self_loss", "weight", "lr", "grad_norm")]
        losses = [float(r["value"]) for r in rows if r["name"] == "train/loss"]
        print(f"recipe bf16: losses {losses}; metrics.csv names {len(names)}", flush=True)
        require(set(names) == set(RECIPE_NAMES) | set(step_names),
                f"recipe: metrics.csv names {sorted(set(names) ^ set(RECIPE_NAMES))}")
        require(len(losses) == 4 and all(math.isfinite(x) for x in losses),
                "recipe: the losses are not 4 finite values")
        ckpt_dir = root / "run_a" / "checkpoints"
        require((ckpt_dir / "best").is_file() and (ckpt_dir / "last").is_file(),
                "recipe: best and last checkpoints not written")
        numbers = {k: v for k, v in res.items() if isinstance(v, float)}
        print(f"recipe bf16 test battery (2 thresholds, MAESTRO): " + ", ".join(
            f"{k} {v:.6f}" for k, v in sorted(numbers.items())), flush=True)
        require(all(0 <= v <= 1 for v in numbers.values()),
                "recipe: a test metric is not in [0, 1]")

        # the best checkpoint (which single_run restored into `state`) into a
        # fresh state
        tx, _ = make_optimizer(1e-3, 1)
        fresh = create_state(build_model(config, fast=True), None, tx)
        g_fresh = torch.Generator(device="cuda")
        CheckpointManager(ckpt_dir).restore("best", fresh, generator=g_fresh)
        payload = torch.load(ckpt_dir / "best", map_location="cpu", weights_only=True)
        sd_eq = lambda m, sd: all(torch.equal(v.cpu(), sd[k]) for k, v in m.state_dict().items())
        same_ckpt = (sd_eq(fresh.student, payload["student"])
                     and sd_eq(fresh.teacher, payload["teacher"])
                     and sd_eq(state.student, payload["student"])
                     and all(torch.equal(a.cpu(), b) for k in ("mu", "nu")
                             for a, b in zip(fresh.opt_state[k], payload["opt_state"][k]))
                     and fresh.step == payload["step"]
                     and torch.equal(g_fresh.get_state(), payload["generator"]))
        print(f"recipe bf16: the best checkpoint (step {payload['step']}) reloads into a fresh "
              f"state bitwise (state dicts, Adam moments, generator): {same_ckpt}", flush=True)
        require(same_ckpt, "recipe: the best checkpoint does not reload bitwise")

        # the store's gather and the cached step against the host path
        idx = next(batcher.epoch_indices(steps=1))
        flat = cache.flat_index(idx)
        gathered = cache.batch_builder(batcher.batch_sizes)(cache.stores,
                                                            cache.index_to_device(flat))
        host = {s: collate([batcher.datasets[s][int(i)] for i in idx[s]]) for s in idx}
        same_gather = all(
            np.array_equal(gathered[s][k].cpu().numpy(), np.asarray(host[s][k]))
            and gathered[s][k].cpu().numpy().dtype == np.asarray(host[s][k]).dtype
            for s in idx for k in ("audio", "labels", "embeddings", "class_mask"))
        st_c, st_h = copy.deepcopy(state), copy.deepcopy(state)
        gen = lambda: torch.Generator(device="cuda").manual_seed(1234)
        m_c = info["step_fn"](st_c, cache.index_to_device(flat), gen())
        m_h = info["train_step"](st_h, host, gen())
        same_step = all(torch.equal(m_c[k], m_h[k]) for k in m_c) and all(
            torch.equal(a, b) for a, b in zip(st_c.student.state_dict().values(),
                                              st_h.student.state_dict().values()))
        print(f"recipe bf16: a gathered batch bitwise equal to the host-collated one: "
              f"{same_gather}; the cached step's metrics and student bitwise equal to the "
              f"host-batch step's: {same_step}", flush=True)
        require(same_gather, "recipe: the store's gather differs from the host batch")
        require(same_step, "recipe: the cached step differs from the host-batch step")

        # one more epoch through the loop (it trains `state` on): launches
        # per step, one blocking host synchronisation per step
        sync_loop = TrainLoop(info["step_fn"], state, batcher, n_epochs=1,
                              logger=MetricsLogger(root / "sync"), rng=loop.rng,
                              index_cache=cache, log_every=2)
        _build.reset_launches()
        _, syncs = syncs_in(sync_loop.run)
        n_sync_steps = sync_loop.history[0]["steps"]
        per_step = {k: v // n_sync_steps if v % n_sync_steps == 0 else v / n_sync_steps
                    for k, v in _build.LAUNCHES.items()}
        _, control = syncs_in(lambda: torch.ones(1, device="cuda").item())
        print(f"recipe bf16: launches per train step {per_step} (phase 8b: {step16_launches}); "
              f"blocking host synchronisations in {n_sync_steps} steps of the loop: "
              f"{len(syncs)}" + "".join(f"\n  {m[:300]}" for m in syncs[:6])
              + f"; a .item() in the same watch: {len(control)}", flush=True)
        require(len(control) == 1, "the synchronisation watch does not see a .item()")
        require(per_step == step16_launches, "recipe: launches per step differ from phase 8b")
        require(len(syncs) == n_sync_steps, "recipe: not one host synchronisation a step")
        # run (a)'s launches less its steps' (at the per-step counts just
        # read) are its eval batches' (per model pass)
        per_eval16 = {}
        for k in sorted(set(launches) | set(per_step)):
            rest = launches.get(k, 0) - steps * per_step.get(k, 0)
            if rest:
                per_eval16[k] = rest // evals if rest % evals == 0 else rest / evals
        print(f"recipe bf16: launches per eval batch per model pass {per_eval16}", flush=True)
        require(per_eval16 == expect_eval16,
                "recipe: the bf16 eval batches' launches differ from 7/7/1")

        # the label-free eval dump from run (a)'s checkpoint (--eval_from_checkpoint)
        _, none = single_run(config, str(root / "run_eval"), fast_dev_run=True, fast=True,
                             test_from_checkpoint=str(ckpt_dir), evaluation=True)
        dumped = {k: len(list((root / "run_eval" / "eval_scores" / "student" / k).glob("*.tsv")))
                  for k in ("raw", "postprocessed")}
        print(f"recipe bf16: eval score files {dumped}", flush=True)
        require(none is None and dumped == {"raw": 24, "postprocessed": 24},
                "recipe: the eval score dump is not one file a clip")

        # run (b): fp32, the test battery from run (a)'s checkpoint
        info_b = {}
        _build.reset_launches()
        t0 = time.perf_counter()
        state_b, res_b = single_run(config, str(root / "run_b"), fast_dev_run=True, fast=False,
                                    test_from_checkpoint=str(ckpt_dir), run_info=info_b)
        run_b_s = time.perf_counter() - t0
        launches_b = dict(_build.LAUNCHES)
        expect_eval = {"conv_bn_stats": 7, "glu_drop_pool": 7, "bigru": 1}
        want_b = {k: v * test_batches for k, v in expect_eval.items()}
        per_eval = {k: v // test_batches for k, v in launches_b.items()}
        print(f"recipe fp32 (test from the bf16 run's best checkpoint): launches {launches_b}, "
              f"expected {want_b}", flush=True)
        require(launches_b == want_b, "recipe: the fp32 test battery did not launch the kernels")
        require(all(v % test_batches == 0 for v in launches_b.values()),
                "recipe: the fp32 launches are not a whole number per test batch")
        require(all(torch.equal(a.cpu(), payload["student"][k])
                    for k, a in state_b.student.state_dict().items()),
                "recipe: run (b) did not restore the best checkpoint")
        enc = info_b["encoder"]
        median = config["net"]["median_filter"]
        test_set = datasets.StronglyAnnotatedSet(
            config["data"]["test_folder"], tbl.read_tsv(config["data"]["test_tsv"]), enc,
            pad_to=10, fs=16000, test=True, return_filename=True,
            embeddings_hdf5_file=_emb_file(config, "devtest"), embedding_type="frame")
        items = [test_set[i] for i in range(bs_val)]
        plain_cfg = copy.deepcopy(config)
        plain_cfg["net"].update(fused_blocks=False, rnn_kernel=False)
        plain = build_model(plain_cfg).cuda()
        plain.load_state_dict(state_b.student.state_dict())
        kw = dict(median_filter=median, as_arrays=True, want_events=False)
        k_raw, k_post, _, k_weak, _ = predict_dataset(info_b["predict_fn"], state_b.student,
                                                      items, enc, bs_val, **kw)
        p_raw, p_post, _, p_weak, _ = predict_dataset(info_b["predict_fn"], plain, items, enc,
                                                      bs_val, **kw)
        stems = [Path(it["filename"]).stem for it in items]
        arr = lambda d: np.stack([d[s].values for s in stems])
        run_post = arr(res_b["scores_postprocessed"])
        err = max(float(np.abs(arr(k_raw) - arr(p_raw)).max()),
                  float(np.abs(arr(k_post) - arr(p_post)).max()),
                  float(np.abs(k_weak - p_weak).max()),
                  float(np.abs(run_post - arr(p_post)).max()))
        same_run = np.array_equal(run_post, arr(k_post))
        print(f"recipe fp32: the first test batch ({bs_val} clips) from the restored weights: "
              f"scores (raw, median-filtered, weak, and run (b)'s own) against the plain "
              f"versions' max err {err:.3e} (tol {TOL_RECIPE}); run (b)'s scores equal the "
              f"kernels' recomputation: {same_run}", flush=True)
        require(bool(np.isfinite(run_post).all()), "recipe: non-finite fp32 test scores")
        require(err <= TOL_RECIPE, "recipe: fp32 test scores disagree with the plain versions")
        require(same_run, "recipe: run (b)'s scores differ from a recomputation")

        # run (c): the path of a run at the conf's scale, where auto mode
        # leaves the train store off (fits_device_cache is false above
        # device_cache_max_bytes): steps take host batches (wav reads,
        # collate, a copy to the card) and validation reads host datasets.
        # Then HOST_EPOCHS more epochs of the loop on host batches from the
        # conf's num_workers threads.
        config_c = copy.deepcopy(config)
        config_c["training"]["device_cache"] = False
        info_c = {}
        _build.reset_launches()
        state_c, res_c = single_run(config_c, str(root / "run_c"), fast_dev_run=True, fast=True,
                                    run_info=info_c)
        launches_c = dict(_build.LAUNCHES)
        loop_c = info_c["loop"]
        print(f"recipe bf16 host path: launches {launches_c}", flush=True)
        require(info_c["cache"] is None, "recipe: run (c) built the train store")
        require(sum(h["steps"] for h in loop_c.history) == steps
                and sum(h["val_s"] is not None for h in loop_c.history) == vals,
                "recipe: run (c) is not 2 epochs of 2 steps with validation")
        require(launches_c == want, "recipe: the host-path run did not launch the kernels")
        require(all(0 <= v <= 1 for v in res_c.values() if isinstance(v, float)),
                "recipe: a host-path test metric is not in [0, 1]")
        host_batcher = MultiSourceBatcher(info_c["batcher"].datasets, info_c["batcher"].batch_sizes,
                                          seed=7, num_workers=config["training"]["num_workers"])
        host_loop = TrainLoop(info_c["step_fn"], state_c, host_batcher, n_epochs=HOST_EPOCHS,
                              logger=MetricsLogger(root / "host"), rng=loop_c.rng, log_every=2)
        _build.reset_launches()
        host_loop.run()
        host_steps = sum(h["steps"] for h in host_loop.history)
        require(dict(_build.LAUNCHES) == {k: host_steps * v for k, v in per_step.items()},
                "recipe: the host-batch loop did not launch the kernels a step")
        with open(root / "host" / "metrics.csv") as f:
            host_losses = [float(r["value"]) for r in csv.DictReader(f)
                           if r["name"] == "train/loss"]
        require(len(host_losses) == host_steps // 2
                and all(math.isfinite(x) for x in host_losses),
                "recipe: the host-batch loop's losses are not finite")

        macs = forward_macs(build_model(config), 626, 128, 496)
        energy = json.loads((root / "run_a" / "energy_train.json").read_text())
        phase_s = time.perf_counter() - t_phase
        for h in loop.history:
            print(f"[{card}] recipe bf16 epoch {h['epoch']}: train {h['seconds']:.3f} s, "
                  f"{h['steps'] / h['seconds']:.2f} steps/s, busy share "
                  f"{h['busy_s'] / h['seconds']:.3f}; validation {h['val_s']:.3f} s",
                  flush=True)
        for h in loop_c.history:
            print(f"[{card}] recipe bf16 host path epoch {h['epoch']} (1 worker): train "
                  f"{h['seconds']:.3f} s, {h['steps'] / h['seconds']:.2f} steps/s; validation "
                  f"from host datasets {h['val_s']:.3f} s", flush=True)
        for h in host_loop.history:
            print(f"[{card}] recipe bf16 host batches, {host_batcher.num_workers} workers, epoch "
                  f"{h['epoch']}: {h['steps']} steps in {h['seconds']:.3f} s, "
                  f"{h['steps'] / h['seconds']:.2f} steps/s, busy share "
                  f"{h['busy_s'] / h['seconds']:.3f}", flush=True)
        print(f"[{card}] recipe: train store {cache.nbytes / 1e6:.1f} MB uploaded in "
              f"{cache.upload_seconds:.3f} s; test battery {info['test_seconds']:.3f} s (bf16), "
              f"{info_b['test_seconds']:.3f} s (fp32); run (a) {run_a_s:.1f} s, run (b) "
              f"{run_b_s:.1f} s; analytic forward {macs['macs'] / 1e6:.3f} MMACs a clip; "
              f"energy estimate {energy['estimated_kwh_range'][0]:.3e}-"
              f"{energy['estimated_kwh_range'][1]:.3e} kWh ({energy['card']}, "
              f"{energy['power_limit_w']} W limit); phase 11 {phase_s:.1f} s", flush=True)
        report["recipe"] = dict(
            clips=n_clips, h5py=with_h5py, corpus_s=corpus_s, steps=steps,
            launches_bf16=launches, per_step_bf16=per_step, launches_fp32=launches_b,
            syncs_per_step=len(syncs) / n_sync_steps, losses=losses, metrics_bf16=numbers,
            metrics_fp32={k: v for k, v in res_b.items() if isinstance(v, float)},
            fp32_score_err=err, epochs=loop.history, store_bytes=cache.nbytes,
            upload_s=cache.upload_seconds, test_s_bf16=info["test_seconds"],
            test_s_fp32=info_b["test_seconds"], run_a_s=run_a_s, run_b_s=run_b_s,
            mmacs=macs["macs"] / 1e6, energy=energy, phase_s=phase_s,
            host_path=dict(launches=launches_c, epochs=loop_c.history,
                           test_s=info_c["test_seconds"], workers=host_batcher.num_workers,
                           host_epochs=host_loop.history))
    return ({"eval_batch": per_eval, "train_step": {}},
            {"eval_batch": per_eval16, "train_step": per_step})


# phase 12: the 2021-2023 recipes (crnn_2023 and the year CLIs, the 2021
# separation recipe)
# clips of each split of the phase's corpus (ten seconds, PCM16, 16 kHz):
# one step an epoch at the confs' batch [24, 24, 48] (the weak split keeps
# 24 of 27; --strong_real adds the 12 strong clips to the 24 synth ones)
YEAR_CLIPS = dict(synth=24, strong=12, weak=27, unlabeled=48, synth_val=24, test=24)
# AST's frame tokens over 10 s (2 + 12 x 101 patches, desed_task_tpu/models/ast.py)
AST_FRAMES = 1214
N_SRC = 4
# the separator on the card against its CPU forward, TF32 off: sources ~0.1
TOL_SEP = 1e-4
# what the launches read from each phase-12 path's run must equal, per
# train step and per eval batch (a model pass), from the models' structure:
# the 2021-2023 CRNN has 7 blocks and a 2-layer
# BiGRU; the 2022 AST conf adds the frame-embedding BiGRU (one layer, H=512);
# the fine-tune's ensemble runs the multisrc CRNN (over the 4 sources of
# each clip) and the frozen monaural one in every forward, and takes
# gradients through the multisrc one only
YEAR_STEP16 = {"conv_bn_stats.bf16": 14, "glu_drop_pool.bf16": 14, "bigru": 4,
               "conv_bn_stats_bwd.bf16": 7, "glu_drop_pool_bwd.bf16": 7, "bigru_bwd": 2}
YEAR_EVAL16 = {"conv_bn_stats.bf16": 7, "glu_drop_pool.bf16": 7, "bigru": 2}
AST_STEP16 = dict(YEAR_STEP16, bigru=6, bigru_bwd=3)
AST_EVAL16 = dict(YEAR_EVAL16, bigru=3)
FINETUNE_STEP = {"conv_bn_stats": 28, "glu_drop_pool": 28, "bigru": 8,
                 "conv_bn_stats_bwd": 7, "glu_drop_pool_bwd": 7, "bigru_bwd": 2}
FINETUNE_EVAL = {"conv_bn_stats": 14, "glu_drop_pool": 14, "bigru": 4}
# the fine-tune step against the plain step: the multisrc CRNN's strong-head
# bias lowered so that the sums of its 4 per-source sigmoids stay below the
# ensemble's clamp at 1 and gradients reach the conv stack and the BiGRU
FINETUNE_HEAD_SHIFT = 4.0


def frozen_bn_blocks(gen, geoms, B: int) -> dict:
    """The fused conv block in eval-mode BatchNorm with gradients (the
    fine-tune's multisrc CNN: freeze_bn) at batch B, forward and backward,
    against the same block through the plain versions: z and every gradient
    within TOL_KERNEL of max(1, max |plain|), bitwise reruns; ms of each."""
    import torch

    from desed_task_tpu_torch.ops import fused_cnn

    dev = torch.device("cuda")
    rows = []
    for i, (T, Fq, ci, co, pool) in enumerate(geoms):
        x = torch.randn(B, T, Fq, ci, generator=gen).to(dev).requires_grad_(i > 0)
        prm = [(torch.randn(3, 3, ci, co, generator=gen) / math.sqrt(9 * ci)).to(dev),
               (torch.randn(co, generator=gen) * 0.05).to(dev),
               (1.0 + 0.1 * torch.randn(co, generator=gen)).to(dev),
               (0.1 * torch.randn(co, generator=gen)).to(dev),
               (torch.randn(co, co, generator=gen) / math.sqrt(co)).to(dev),
               (0.1 * torch.randn(co, generator=gen)).to(dev)]
        for p in prm:
            p.requires_grad_()
        ra_mean = (torch.randn(co, generator=gen) * 0.1).to(dev)
        ra_var = (1.0 + torch.rand(co, generator=gen)).to(dev)
        g = torch.randn(B, T // pool[0], Fq // pool[1], co, generator=gen).to(dev)
        inputs = prm + ([x] if i > 0 else [])

        def kernel_block():
            w, b, gamma, beta, wg, bg = prm
            z, _, _ = fused_cnn.fused_glu_block(x, w, b, gamma, beta, ra_mean, ra_var, wg, bg,
                                                pool=pool, train=False)
            return (z.detach(), *torch.autograd.grad(z, inputs, g))

        def plain_block():
            w, b, gamma, beta, wg, bg = prm
            y, _, _ = fused_cnn.conv_bn_stats_plain(x, w, b)
            scale = gamma * torch.rsqrt(ra_var + 1e-3)
            shift = beta - ra_mean * scale
            z = fused_cnn.glu_drop_pool_plain(y, scale.repeat(Fq), shift.repeat(Fq), wg, bg,
                                              None, pool=pool)
            return (z.detach(), *torch.autograd.grad(z, inputs, g))

        got, want = kernel_block(), plain_block()
        err = max(rel_err(a, b) for a, b in zip(got, want))
        same = all(torch.equal(a, b) for a, b in zip(got, kernel_block()))
        print(f"frozen-BN block {i} B={B} T={T:3d} F={Fq:3d} {ci:3d}->{co:3d}: z and "
              f"gradients max err {err:.3e} (tol {TOL_KERNEL}); rerun bitwise equal: {same}",
              flush=True)
        require(err <= TOL_KERNEL, "the frozen-BN block disagrees with its plain version")
        require(same, "the frozen-BN block is not bitwise repeatable")
        rows.append(dict(geom=[B, T, Fq, ci, co], err=err,
                         ms=time_ms(kernel_block, iters=3, warmup=1),
                         plain_ms=time_ms(plain_block, iters=2, warmup=1)))
        del x, g, got, want, inputs
        torch.cuda.empty_cache()
    return dict(blocks=rows, ms=sum(r["ms"] for r in rows),
                plain_ms=sum(r["plain_ms"] for r in rows), err=max(r["err"] for r in rows))


def bigru_two_layers(gen, B: int, T: int = 156) -> dict:
    """The 2021-2023 CRNN's BiGRU (2 layers, H=128, on the 128 features of
    the conv stack) at batch B, forward and backward, through the kernels
    (the cluster plan: a ragged last CTA) against the plain versions."""
    import torch

    from desed_task_tpu_torch.models.rnn import BidirectionalGRU

    H = 128
    plan = gru_plan(B, T, H)
    require(plan["plan"] == "cluster", f"H={H} does not take the cluster kernels")
    dev = torch.device("cuda")
    k = BidirectionalGRU(128, H, 2, kernel=True).to(dev)
    p = BidirectionalGRU(128, H, 2, kernel=False).to(dev)
    with torch.no_grad():
        for a in k.parameters():
            a.copy_(((torch.rand(a.shape, generator=gen) * 2 - 1) / math.sqrt(H)).to(dev))
    p.load_state_dict(k.state_dict())
    x = torch.randn(B, T, 128, generator=gen).to(dev).requires_grad_()
    g = torch.randn(B, T, 2 * H, generator=gen).to(dev)

    def run(m):
        out = m(x, train=False)
        return (out.detach(), *torch.autograd.grad(out, [x, *m.parameters()], g))

    got, want = run(k), run(p)
    err = max(rel_err(a, b) for a, b in zip(got, want))
    same = all(torch.equal(a, b) for a, b in zip(got, run(k)))
    print(f"bigru 2 layers B={B} T={T} H={H} {plan}: forward and gradients max err "
          f"{err:.3e} (tol {TOL_KERNEL}); rerun bitwise equal: {same}", flush=True)
    require(err <= TOL_KERNEL, "the 2-layer BiGRU disagrees with its plain version")
    require(same, "the 2-layer BiGRU is not bitwise repeatable")
    return dict(B=B, T=T, H=H, **plan, err=err, ms=time_ms(lambda: run(k), iters=5),
                plain_ms=time_ms(lambda: run(p), iters=2, warmup=1))


class StepLaunches(dict):
    """A run_info for an entry point that reads the kernel launches of each
    train step of the run itself: as the run hands over its TrainLoop, the
    loop's step function is wrapped to count around each call (`steps`, a
    dict of launches a step)."""

    def __init__(self):
        super().__init__()
        self.steps = []

    def update(self, *args, **kw):
        super().update(*args, **kw)
        loop = self.get("loop")
        if loop is None or getattr(loop.step_fn, "counts_launches", False):
            return
        from desed_task_tpu_torch.ops import _build

        inner = loop.step_fn

        def step(*a):
            before = dict(_build.LAUNCHES)
            out = inner(*a)
            self.steps.append({k: v - before.get(k, 0) for k, v in _build.LAUNCHES.items()
                               if v != before.get(k, 0)})
            return out

        step.counts_launches = True
        loop.step_fn = step


def ensemble_state(config: dict, ckpt_dir: Path, kernels: bool, head_shift: float = 0.0):
    """The fine-tune's state from a SED checkpoint, as sepsed_single_run
    builds it, through the kernels or (kernels=False) the plain versions;
    the multisrc CRNN's strong-head bias lowered by head_shift."""
    import torch

    from desed_task_tpu_torch.training import create_state, make_optimizer
    from desed_task_tpu_torch.training.sepsed_run import build_ensemble

    if not kernels:
        config = dict(config, net=dict(config["net"], fused_blocks=False, rnn_kernel=False))
    model = build_ensemble(config, str(ckpt_dir))
    with torch.no_grad():
        model.multisrc_crnn.dense.bias -= head_shift
    tx, sched = make_optimizer(config["opt"]["lr"], 3)
    return create_state(model, None, tx), tx, sched


def recipes_2021_2023(card, report):
    """Phase 12: the 2021-2023 recipes through their entry points on the
    card at full width, and the fine-tune's kernels at its shapes."""
    import csv

    import torch
    import yaml

    from desed_task_tpu_torch.data import datasets
    from desed_task_tpu_torch.data.audio_io import read_wav
    from desed_task_tpu_torch.models.tdcn import TDCNPP
    from desed_task_tpu_torch.obs.logging import MetricsLogger
    from desed_task_tpu_torch.ops import _build
    from desed_task_tpu_torch.ops.frontend import MelConfig
    from desed_task_tpu_torch.recipes import (
        dcase2021_finetune_on_separated, dcase2021_pretrain_separation,
        dcase2021_run_separation, dcase2022_train_pretrained, dcase2023_train_sed)
    from desed_task_tpu_torch.recipes_config import crnn_2023
    from desed_task_tpu_torch.tools.separation import TorchSeparationModel
    from desed_task_tpu_torch.training.loop import TrainLoop
    from desed_task_tpu_torch.training.mean_teacher import MeanTeacherConfig, SlotSpec
    from desed_task_tpu_torch.training.sepsed import make_sepsed_train_step

    out = {}
    t_phase = time.perf_counter()
    gen = torch.Generator().manual_seed(12)
    geoms = block_geometries(crnn_2023(), MelConfig(), 160000)
    out["frozen_bn_384"] = frozen_bn_blocks(gen, geoms, 4 * 96)
    out["bigru_2layer"] = [bigru_two_layers(gen, B) for B in (96, 4 * 96)]

    confs = ROOT / "recipes"
    with tempfile.TemporaryDirectory(prefix="years_") as tmp:
        root = Path(tmp)
        t0 = time.perf_counter()
        n_clips, _, with_h5py = write_corpus(root, np.random.default_rng(18), YEAR_CLIPS, "ast",
                                             AST_FRAMES, maestro=False)
        out["corpus_s"] = time.perf_counter() - t0
        if not with_h5py:
            print("embedding store: in-memory stand-in (no h5py here)", flush=True)
            datasets._EmbeddingStore = InMemoryEmbeddings
        print(f"years: corpus of {n_clips} ten-second clips, 768x{AST_FRAMES} float16 AST "
              f"embeddings each, written in {out['corpus_s']:.2f} s", flush=True)

        def conf(rel, name):
            path = root / name
            path.write_text(yaml.safe_dump(year_config(confs / rel, root)))
            return path

        def epochs(log):
            with open(log / "metrics.csv") as f:
                rows = list(csv.DictReader(f))
            return ([float(r["value"]) for r in rows if r["name"] == "train/epoch_seconds"],
                    [float(r["value"]) for r in rows if r["name"] == "train/loss"])

        def path_launches(tag, info, launches, evals, step, ev):
            """A path's launches a train step, read around each step of its
            run (StepLaunches), and a model pass of an eval batch: the rest
            of the run's launches over its `evals` eval batches. Each is
            held to the model's count."""
            per_step = info.steps[0] if info.steps else {}
            rest = {k: launches.get(k, 0) - len(info.steps) * per_step.get(k, 0)
                    for k in set(launches) | set(per_step)}
            per_eval = {k: v // evals if v % evals == 0 else v / evals
                        for k, v in sorted(rest.items()) if v}
            print(f"{tag}: launches {launches} in {len(info.steps)} steps and {evals} eval "
                  f"batches: a step {info.steps}, expected {step}; an eval batch (a model "
                  f"pass) {per_eval}, expected {ev}", flush=True)
            require(len(info.steps) == 2 and all(x == step for x in info.steps),
                    f"{tag}: a train step's launches differ from the model's")
            require(per_eval == ev, f"{tag}: an eval batch's launches differ from the model's")
            return {"train_step": per_step, "eval_batch": per_eval}

        def check_scores(tag, res):
            numbers = {k: v for k, v in res.items() if isinstance(v, float)}
            print(f"{tag} test battery: " + ", ".join(
                f"{k} {v:.6f}" for k, v in sorted(numbers.items())), flush=True)
            require(all(math.isfinite(v) and 0 <= v <= 1 for v in numbers.values()),
                    f"{tag}: a test metric is not finite in [0, 1]")
            return numbers

        # (a) 2023 SED recipe, bf16 (the CLI's default), --strong_real
        conf_a = conf("dcase2023_task4_baseline/confs/default.yaml", "2023_default.yaml")
        info_a = StepLaunches()
        _build.reset_launches()
        t0 = time.perf_counter()
        _, res_a = dcase2023_train_sed.main(["--conf_file", str(conf_a), "--log_dir",
                                             str(root / "run_a"), "--fast_dev_run",
                                             "--strong_real"], run_info=info_a)
        run_a_s = time.perf_counter() - t0
        # an epoch: one step; validation: weak (3 clips) and synth_val (24)
        # for student and teacher; the test battery: 24 clips, student
        by_path = {"recipe_2023_bf16": path_launches(
            "recipe 2023 bf16 (a)", info_a, dict(_build.LAUNCHES), 2 * 4 + 1, YEAR_STEP16,
            YEAR_EVAL16)}
        ep_a, losses_a = epochs(root / "run_a")
        out["run_a"] = dict(s=run_a_s, epoch_s=ep_a, metrics=check_scores("recipe 2023 (a)",
                                                                          res_a))
        require((root / "run_a" / "checkpoints" / "best").is_file(), "(a): no best checkpoint")

        # (b) 2022 pretrained, AST frame embeddings through the frame BiGRU
        conf_b = conf("dcase2022_task4_baseline/confs/pretrained_ast.yaml", "2022_ast.yaml")
        require(gru_plan(96, AST_FRAMES, 512)["plan"] == "stream",
                "the AST frame encoder does not take the stream kernels")
        info_b = StepLaunches()
        _build.reset_launches()
        t0 = time.perf_counter()
        _, res_b = dcase2022_train_pretrained.main(["--conf_file", str(conf_b), "--log_dir",
                                                    str(root / "run_b"), "--fast_dev_run"],
                                                   run_info=info_b)
        run_b_s = time.perf_counter() - t0
        by_path["recipe_2022_ast_bf16"] = path_launches(
            "recipe 2022 AST bf16 (b)", info_b, dict(_build.LAUNCHES), 2 * 4 + 1, AST_STEP16,
            AST_EVAL16)
        ep_b, _ = epochs(root / "run_b")
        out["run_b"] = dict(s=run_b_s, epoch_s=ep_b, metrics=check_scores("recipe 2022 AST (b)",
                                                                          res_b))

        # (c) MixIT pretraining of the full-width separator: 2 epochs of 2
        # steps of 16 four-second segments, SI-SNRi on 32 pairs each epoch
        _build.reset_launches()
        t0 = time.perf_counter()
        model_c, best = dcase2021_pretrain_separation.main([
            "--train_folders", str(root / "unlabeled"), "--val_folders", str(root / "synth_val"),
            "--log_dir", str(root / "mixit"), "--epochs", "2", "--steps_per_epoch", "2"])
        run_c_s = time.perf_counter() - t0
        with open(root / "mixit" / "metrics.csv") as f:
            rows_c = list(csv.DictReader(f))
        mixit = {n: [float(r["value"]) for r in rows_c if r["name"] == n]
                 for n in ("train/mixit_loss", "val/si_snri_db", "train/epoch_seconds")}
        n_params = sum(p.numel() for p in model_c.parameters())
        print(f"mixit (c): TDCNPP() {n_params} parameters, losses {mixit['train/mixit_loss']}, "
              f"SI-SNRi {mixit['val/si_snri_db']} dB, epochs {mixit['train/epoch_seconds']} s; "
              f"launches {dict(_build.LAUNCHES)} (none: no Pallas kernel in the TDCN)",
              flush=True)
        require(best.is_file() and all(math.isfinite(v) for vs in mixit.values() for v in vs),
                "(c): no best checkpoint or non-finite MixIT metrics")
        require(not _build.LAUNCHES, "(c): a CRNN kernel launched")
        out["run_c"] = dict(s=run_c_s, **mixit, params=n_params)

        # the separator on the card against its CPU forward (TF32 off)
        sep = TorchSeparationModel(str(best))
        cpu = TDCNPP(**torch.load(best, weights_only=True)["config"])
        cpu.load_state_dict(torch.load(best, weights_only=True)["state_dict"])
        clip, _ = read_wav(root / "test" / "test_000.wav")
        padded = np.zeros(1 << 18, np.float32)
        padded[: len(clip)] = clip
        x_sep = torch.as_tensor(padded, device="cuda")[None]
        # as a user's process runs it: TF32 allowed (PyTorch's default for
        # cuDNN; main turns it off for the plain versions), which the
        # separator turns off itself; _separate is its forward without that
        flags = (torch.backends.cudnn, torch.backends.cuda.matmul)
        for f in flags:
            f.allow_tf32 = True
        try:
            got = sep.separate(clip)
            with torch.no_grad():
                tf32 = sep.model._separate(x_sep)[0, :, : len(clip)].cpu().numpy()
        finally:
            for f in flags:
                f.allow_tf32 = False
        with torch.no_grad():
            want = cpu(torch.from_numpy(padded)[None])[0, :, : len(clip)].numpy()
        sep_err = float(np.abs(got - want).max())
        tf32_err = float(np.abs(tf32 - want).max())
        mix_err = float(np.abs(got.sum(0) - clip).max())
        print(f"separator (c): a ten-second clip on the card against the CPU forward, TF32 "
              f"allowed in the process, max err {sep_err:.3e} (tol {TOL_SEP}; sources up to "
              f"{np.abs(want).max():.3f}; the forward without its fp32 pin {tf32_err:.3e}); the "
              f"sources sum to the clip within {mix_err:.3e}", flush=True)
        require(sep_err <= TOL_SEP, "the separator on the card disagrees with the CPU")
        with torch.no_grad():
            sep_ms = time_ms(lambda: sep.model(x_sep), iters=5)
        out["separator"] = dict(err=sep_err, tf32_err=tf32_err, mix_err=mix_err, clip_ms=sep_ms)

        # (d) separation of the corpus's folders with (c)'s checkpoint
        folders = [str(root / s) for s in ("synth", "weak", "unlabeled", "synth_val", "test")]
        _build.reset_launches()
        t0 = time.perf_counter()
        counts = dcase2021_run_separation.main(["--backend", "torch", "--checkpoint", str(best),
                                                "--folders", *folders])
        run_d_s = time.perf_counter() - t0
        n_sep = sum(counts.values())
        written = sum(len(list(Path(f + "_separated").glob("*_src*.wav"))) for f in folders)
        print(f"separation (d): {n_sep} clips, {written} source files in {run_d_s:.2f} s "
              f"({run_d_s / n_sep * 1e3:.1f} ms a clip; one clip's forward alone "
              f"{sep_ms:.2f} ms)", flush=True)
        require(written == N_SRC * n_sep and not _build.LAUNCHES, "(d): sources not written")
        out["run_d"] = dict(s=run_d_s, clips=n_sep)

        # (e) the separation-ensemble fine-tune from (a)'s checkpoint, fp32
        conf_e = conf("dcase2021_task4_baseline/confs/sep+sed.yaml", "2021_sep_sed.yaml")
        info = StepLaunches()
        _build.reset_launches()
        t0 = time.perf_counter()
        state_e, res_e = dcase2021_finetune_on_separated.main(
            ["--conf_file", str(conf_e), "--sed_checkpoint", str(root / "run_a" / "checkpoints"),
             "--log_dir", str(root / "run_e"), "--fast_dev_run"], run_info=info)
        run_e_s = time.perf_counter() - t0
        by_path["finetune"] = path_launches("fine-tune fp32 (e)", info, dict(_build.LAUNCHES),
                                            2 * 4 + 1, FINETUNE_STEP, FINETUNE_EVAL)
        ep_e, _ = epochs(root / "run_e")
        out["run_e"] = dict(s=run_e_s, epoch_s=ep_e, q=float(torch.sigmoid(
            state_e.teacher.q_logit)), metrics=check_scores("fine-tune (e)", res_e))

        # the fine-tune step at the conf's batch: 96 clips x 4 sources
        config_e = yaml.safe_load(conf_e.read_text())
        batcher = info["batcher"]
        t0 = time.perf_counter()
        batch = next(iter(batcher.epoch(steps=1)))
        host_batch_s = time.perf_counter() - t0
        nbytes = sum(v.nbytes for s in batch.values() for k, v in s.items()
                     if isinstance(v, np.ndarray))
        dev_batch = {s: {k: torch.as_tensor(v, device="cuda") for k, v in d.items()
                         if k in ("audio", "labels")} for s, d in batch.items()}
        cfg = MeanTeacherConfig(slots=tuple(SlotSpec(n, len(batch[n]["audio"]), r) for n, r in
                                            (("synth", "strong"), ("weak", "weak"),
                                             ("unlabeled", "unlabeled"))),
                                mixup=None, rampup_steps=3, weak_labels_post_mixup=False)
        require(cfg.batch_size == 96, "the fine-tune batch is not 96 clips")
        ckpt_a = root / "run_a" / "checkpoints"

        def run(kernels, seed=7, shift=FINETUNE_HEAD_SHIFT):
            st, tx, sched = ensemble_state(config_e, ckpt_a, kernels, shift)
            step = make_sepsed_train_step(cfg, tx, sched)
            m = step(st, dev_batch, torch.Generator(device="cuda").manual_seed(seed))
            torch.cuda.synchronize()
            return st, step, {k: float(v) for k, v in m.items()}, [
                p.grad.clone() for p in st.student.parameters()]

        # from (a)'s weights as they are, every frame's sum over the 4
        # sources is clamped at 1, and the clamp passes no gradient to the
        # multisrc CRNN
        st_raw, _, _, g_raw = run(True, shift=0.0)
        names = [n for n, _ in st_raw.student.named_parameters()]
        cnn_max = lambda gs: max(float(g.abs().max()) for n, g in zip(names, gs)
                                 if n.startswith("multisrc_crnn.cnn."))
        raw_cnn = cnn_max(g_raw)
        del st_raw, g_raw
        _build.reset_launches()
        st_k, step_k, m_k, g_k = run(True)
        per_step = dict(_build.LAUNCHES)
        print(f"fine-tune step (96 clips x {N_SRC} sources): launches {per_step}, expected "
              f"{FINETUNE_STEP}", flush=True)
        require(per_step == FINETUNE_STEP, "the fine-tune step's launches differ")
        st_p, step_p, m_p, g_p = run(False)
        require(dict(_build.LAUNCHES) == per_step, "the plain fine-tune step launched a kernel")
        loss_err = max(abs(m_k[k] - m_p[k]) / max(abs(m_p[k]), 1e-6) for k in m_k)
        grad_errs = {n: float((a - b).abs().max()) / max(float(b.abs().max()), 1e-3)
                     for n, a, b in zip(names, g_k, g_p)}
        worst = max(grad_errs, key=grad_errs.get)
        _, _, m_k2, g_k2 = run(True)
        same = m_k2 == m_k and all(torch.equal(a, b) for a, b in zip(g_k, g_k2))
        print("fine-tune step metrics: " + ", ".join(f"{k} {v:.6g}" for k, v in m_k.items())
              + f"; against the plain step: metrics max rel err {loss_err:.3e} (tol {TOL_LOSS}), "
              f"gradients max err {grad_errs[worst]:.3e} at {worst} (tol {TOL_GRAD}), q_logit's "
              f"{grad_errs['q_logit']:.3e}; rerun bitwise equal: {same}", flush=True)
        require(all(math.isfinite(v) for v in m_k.values()), "non-finite fine-tune metrics")
        require(loss_err <= TOL_LOSS, "fine-tune metrics disagree with the plain step")
        require(grad_errs[worst] <= TOL_GRAD, "fine-tune gradients disagree with the plain step")
        require(same, "the fine-tune step is not bitwise repeatable")
        k_cnn = cnn_max(g_k)
        print(f"fine-tune step: largest conv-stack gradient {k_cnn:.3e} with the multisrc head's "
              f"bias lowered by {FINETUNE_HEAD_SHIFT} ({raw_cnn:.3e} from (a)'s weights as they "
              f"are)", flush=True)
        require(k_cnn > 0, "no gradient reached the multisrc conv stack")
        gen_t = torch.Generator(device="cuda").manual_seed(11)
        torch.cuda.reset_peak_memory_stats()
        step_ms = time_ms(lambda: step_k(st_k, dev_batch, gen_t), iters=5, warmup=1)
        peak = torch.cuda.max_memory_allocated()
        plain_ms = time_ms(lambda: step_p(st_p, dev_batch, gen_t), iters=2, warmup=1)
        del st_p, g_p
        # host batches: 3 more epochs of the loop from the conf's 6 workers
        host_loop = TrainLoop(step_k, st_k, type(batcher)(
            batcher.datasets, batcher.batch_sizes, seed=5,
            num_workers=config_e["training"]["num_workers"]),
            n_epochs=3, logger=MetricsLogger(root / "host_e"),
            rng=torch.Generator(device="cuda").manual_seed(3))
        host_loop.run()
        busy = [h["busy_s"] / h["seconds"] for h in host_loop.history]
        print(f"[{card}] fine-tune step, 96 clips x {N_SRC} sources (B={4 * 96} through the "
              f"multisrc CRNN), fp32: {step_ms:.3f} ms ({96 / step_ms * 1e3:.1f} clips/s; plain "
              f"versions {plain_ms:.3f} ms; peak memory {peak / 2**30:.2f} GiB); a host batch "
              f"({nbytes / 1e6:.1f} MB) read and collated in {host_batch_s:.3f} s on 1 thread; "
              f"host-batch epochs of one step (6 workers): "
              + ", ".join(f"{h['seconds']:.3f} s" for h in host_loop.history)
              + f", busy share {', '.join(f'{b:.3f}' for b in busy)}", flush=True)
        out["finetune_step"] = dict(
            launches=per_step, metrics=m_k, plain_metrics=m_p, metric_rel_err=loss_err,
            cnn_grad_max=k_cnn, cnn_grad_max_unshifted=raw_cnn,
            grad_errs=grad_errs, bitwise_repeat=same, step_ms=step_ms, plain_step_ms=plain_ms,
            peak_bytes=peak, host_batch_s=host_batch_s, host_batch_bytes=nbytes,
            host_epochs=host_loop.history)
        del st_k, g_k, g_k2, dev_batch, batch, host_loop
        torch.cuda.empty_cache()

    fb = out["frozen_bn_384"]
    g96, g384 = out["bigru_2layer"]
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"[{card}] frozen-BN conv stack, B={4 * 96}, forward and backward, seven blocks: "
          f"{fb['ms']:.3f} ms (plain versions {fb['plain_ms']:.3f} ms); 2-layer BiGRU H=128 "
          f"forward and backward: B=96 {g96['ms']:.3f} ms (plain {g96['plain_ms']:.3f}), "
          f"B=384 {g384['ms']:.3f} ms (plain {g384['plain_ms']:.3f})", flush=True)
    print(f"[{card}] years: (a) 2023 SED bf16 {out['run_a']['s']:.1f} s (epochs "
          f"{out['run_a']['epoch_s']}), (b) 2022 AST bf16 {out['run_b']['s']:.1f} s (epochs "
          f"{out['run_b']['epoch_s']}), (c) MixIT {out['run_c']['s']:.1f} s, (d) separation "
          f"{out['run_d']['s']:.1f} s, (e) fine-tune {out['run_e']['s']:.1f} s (epochs "
          f"{out['run_e']['epoch_s']}); phase 12 {out['phase_s']:.1f} s", flush=True)
    out["launches_by_path"] = by_path
    report["years"] = out
    return by_path


# phase 13: the embedders (BEATs, PANNs, AST), their extraction, BEATs inside
# the train step and the serving forward, BEATs pretraining
EMB_CLIPS = 60  # the 2024 train batch
PANNS_CLIPS, AST_CLIPS = 16, 8
N_CMP = 4  # clips of each embedder's forward held to the same module on the CPU
TOL_EMB = 1e-4  # card against CPU, of max(1, max |CPU|), TF32 allowed in the process
TOL_STORE = 1e-6  # extracted rows against the forward of the same batches
EXTRACT_BATCH = 8
SPLIT_WAVS = {"split_a": 12, "split_b": 7}  # the last batch of each is padded
PRETRAIN_WAVS, PRETRAIN_STEPS, FINETUNE_STEPS = 32, 4, 2


def beats_flops(cfg, tokens: int) -> float:
    """FLOPs of one clip's BEATs forward (2 a MAC; the fbank's FFT left out)."""
    d, f, p = cfg.encoder_embed_dim, cfg.encoder_ffn_embed_dim, cfg.input_patch_size
    macs = tokens * (p * p * cfg.embed_dim + cfg.embed_dim * d)  # patch conv, projection
    macs += tokens * d * (d // cfg.conv_pos_groups) * cfg.conv_pos  # positional conv
    macs += cfg.encoder_layers * (4 * tokens * d * d + 2 * tokens * d * f
                                  + 2 * tokens * tokens * d)
    return 2.0 * macs


def panns_flops(frames: int) -> float:
    """FLOPs of one clip's Cnn14_16k conv stack (3x3 convs, 2 a MAC)."""
    macs, t, f, ci = 0, frames, 64, 1
    for i, co in enumerate((64, 128, 256, 512, 1024, 2048)):
        macs += t * f * 9 * (ci * co + co * co)
        ci = co
        if i < 5:
            t, f = t // 2, f // 2
    return 2.0 * macs


def ast_flops(cfg) -> float:
    """FLOPs of one spectrogram's AST forward (2 a MAC)."""
    n, d = 2 + cfg.num_patches, cfg.embed_dim
    macs = cfg.num_patches * cfg.patch_size ** 2 * d
    macs += cfg.depth * (4 * n * d * d + 2 * n * d * int(d * cfg.mlp_ratio) + 2 * n * n * d)
    return 2.0 * macs


class MemoryH5:
    """The h5py calls of tools/embeddings.extract_folder, into this process:
    each store's arrays in `files`, its frame rows also in
    InMemoryEmbeddings.rows (the datasets' stand-in store), and an empty
    placeholder file at its path. Phase 13's stand-in where h5py cannot be
    imported."""

    files: dict = {}

    @staticmethod
    def string_dtype():
        return object

    class File(dict):
        def __init__(self, path, mode):
            super().__init__()
            self.path = str(path)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            if exc[0] is None:
                MemoryH5.files[self.path] = dict(self)
                InMemoryEmbeddings.rows[self.path] = dict(
                    zip(self["filenames"], self["frame_embeddings"]))
                Path(self.path).touch()
            return False

        def create_dataset(self, name, shape, dtype):
            self[name] = np.zeros(shape, dtype)
            return self[name]


def read_store(path, h5) -> dict:
    """An extracted store's arrays (filenames as str)."""
    if h5 is MemoryH5:
        data = MemoryH5.files[str(path)]
        return {**data, "filenames": [str(s) for s in data["filenames"]]}
    import h5py

    with h5py.File(path, "r") as f:
        return {"global_embeddings": f["global_embeddings"][:],
                "frame_embeddings": f["frame_embeddings"][:],
                "filenames": [s.decode() for s in f["filenames"][:]]}


def embedders(card, report):
    """Phase 13: BEATs, PANNs and AST at full width on seeded weights loaded
    through the released-layout loaders; extraction and a 2024 recipe run
    from its stores; BEATs inside the train step and the serving forward;
    BEATs pretraining and fine-tuning."""
    import copy
    import csv
    import dataclasses

    import torch

    from desed_task_tpu_torch.data import datasets
    from desed_task_tpu_torch.data.audio_io import read_audio, write_wav
    from desed_task_tpu_torch.inference.pipeline import InferencePipeline
    from desed_task_tpu_torch.labels.encoder import ManyHotEncoder
    from desed_task_tpu_torch.models.ast import ASTModel, init_ast
    from desed_task_tpu_torch.models.beats import BEATsConfig, BEATsModel, init_beats
    from desed_task_tpu_torch.models.convert import (to_reference_ast, to_reference_beats,
                                                     to_reference_panns)
    from desed_task_tpu_torch.models.panns import Cnn14_16k, init_panns
    from desed_task_tpu_torch.ops import _build
    from desed_task_tpu_torch.ops.frontend import MelConfig
    from desed_task_tpu_torch.ops.kaldi import ast_preprocess
    from desed_task_tpu_torch.recipes_config import MEDIAN_2024, crnn_2024, mean_teacher_2024
    from desed_task_tpu_torch.tools.embeddings import (build_embedder, extract_splits,
                                                       frame_embedder)
    from desed_task_tpu_torch.training import create_state, make_optimizer, make_train_step
    from desed_task_tpu_torch.training.beats_pretrain import (BEATsPretrainConfig,
                                                              finetune_beats_weak, n_tokens_for,
                                                              pretrain_beats)
    from desed_task_tpu_torch.training.single_run import single_run
    from desed_task_tpu_torch.utils.classes_dict import CLASSES_DESED, CLASSES_MAESTRO_REAL
    from desed_task_tpu_torch.utils.cli import EXTRACT_SPLITS

    out = {}
    t_phase = time.perf_counter()
    gen = torch.Generator().manual_seed(13)
    rng = np.random.default_rng(13)
    try:
        import h5py  # noqa: F401

        h5 = None
    except ImportError:
        h5 = MemoryH5
        print("embedding stores: in-memory stand-in (no h5py here)", flush=True)
        datasets._EmbeddingStore = InMemoryEmbeddings

    def hold(name, model, x, flops, n_bytes):
        """The card's forward on N_CMP inputs against the same module on the
        CPU, with TF32 allowed in the process; ms of the whole batch."""
        flags = (torch.backends.cudnn, torch.backends.cuda.matmul)
        prev = [f.allow_tf32 for f in flags]
        for f in flags:
            f.allow_tf32 = True
        try:
            with torch.inference_mode():
                card_out = model(x[:N_CMP])
                cpu_out = copy.deepcopy(model).cpu()(x[:N_CMP].cpu())
        finally:
            for f, p in zip(flags, prev):
                f.allow_tf32 = p
        errs = {k: rel_err(card_out[k].cpu(), cpu_out[k]) for k in ("frame", "global")}
        with torch.inference_mode():
            ms = time_ms(lambda: model(x), iters=5, warmup=1)
        b_ms, by = bound_ms(n_bytes, flops)
        print(f"[{card}] {name}: {ms:.3f} ms a batch of {x.shape[0]} "
              f"({flops / 1e12:.3f} TFLOP), "
              f"bound {b_ms:.3f} ms ({by}); card against the CPU on {N_CMP} with TF32 allowed: "
              f"frame {errs['frame']:.3e}, global {errs['global']:.3e} (tol {TOL_EMB})",
              flush=True)
        require(max(errs.values()) <= TOL_EMB, f"{name}: the card's forward is not the CPU's")
        return dict(ms=ms, bound_ms=b_ms, bound_by=by, tflop=flops / 1e12, cpu_errs=errs)

    with tempfile.TemporaryDirectory(prefix="embedders_") as tmp:
        root = Path(tmp)
        # facsimiles of the released files, written from seeded modules
        cfg_b = BEATsConfig()
        beats_w = init_beats(BEATsModel(cfg_b), gen)
        sd = to_reference_beats(beats_w.encoder.state_dict(), cfg_b.encoder_layers)
        sd["predictor.weight"] = 0.02 * torch.randn(527, 768, generator=gen)
        sd["predictor.bias"] = torch.zeros(527)
        beats_file = root / "BEATs_iter3_plus_AS2M_facsimile.pt"
        torch.save({"cfg": {**dataclasses.asdict(cfg_b), "finetuned_model": True,
                            "predictor_class": 527, "dropout": 0.1}, "model": sd}, beats_file)
        panns_w = init_panns(Cnn14_16k(), gen)
        panns_file = root / "Cnn14_16k_facsimile.pth"
        torch.save({"model": to_reference_panns(panns_w.state_dict())}, panns_file)
        ast_w = init_ast(ASTModel(), gen)
        ast_file = root / "audioset_10_10_0.4593_facsimile.pth"
        torch.save(to_reference_ast(ast_w.state_dict()), ast_file)
        beats = build_embedder("beats", beats_file)
        panns = build_embedder("panns", panns_file)
        ast = build_embedder("ast", ast_file)
        same = all(all(torch.equal(a.cpu(), b) for a, b in zip(m.state_dict().values(),
                                                               w.state_dict().values()))
                   for m, w in ((beats, beats_w), (panns, panns_w), (ast, ast_w)))
        print(f"embedders: BEATs, PANNs and AST facsimiles (released layouts) load through "
              f"build_embedder to the weights they were written from: {same}", flush=True)
        require(same, "a facsimile did not load back to its weights")
        del beats_w, panns_w, ast_w

        # (a) BEATs on 60 ten-second clips
        audio = torch.as_tensor(rng.standard_normal((EMB_CLIPS, 160000), np.float32) * 0.1,
                                device="cuda")
        with torch.inference_mode():
            emb = beats(audio)
        tokens = n_tokens_for(cfg_b, 160000)
        require(tuple(emb["frame"].shape) == (EMB_CLIPS, 768, tokens) == (60, 768, 496)
                and tuple(emb["global"].shape) == (EMB_CLIPS, 768)
                and bool(torch.isfinite(emb["frame"]).all()), "BEATs: bad output")
        w_bytes = 4 * sum(p.numel() for p in beats.parameters())
        out["beats"] = hold("BEATs", beats, audio, EMB_CLIPS * beats_flops(cfg_b, tokens),
                            audio.numel() * 4 + w_bytes + emb["frame"].numel() * 4)
        del emb
        # (b) PANNs on 16 clips, AST on 8 spectrograms
        a16 = audio[:PANNS_CLIPS]
        with torch.inference_mode():
            p_out = panns(a16)
        require(tuple(p_out["frame"].shape) == (PANNS_CLIPS, 2048, 125)
                and tuple(p_out["global"].shape) == (PANNS_CLIPS, 2048)
                and bool(torch.isfinite(p_out["frame"]).all()), "PANNs: bad output")
        out["panns"] = hold("PANNs Cnn14_16k", panns, a16, PANNS_CLIPS * panns_flops(1001),
                            a16.numel() * 4 + 4 * sum(p.numel() for p in panns.parameters())
                            + p_out["frame"].numel() * 4)
        spec = ast_preprocess(audio[:AST_CLIPS].cpu()).cuda()
        with torch.inference_mode():
            a_out = ast(spec)
        require(tuple(a_out["frame"].shape) == (AST_CLIPS, 768, 1214)
                and bool(torch.isfinite(a_out["frame"]).all()), "AST: bad output")
        out["ast"] = hold("AST", ast, spec, AST_CLIPS * ast_flops(ast.cfg),
                          spec.numel() * 4 + 4 * sum(p.numel() for p in ast.parameters())
                          + a_out["frame"].numel() * 4)
        del panns, ast, p_out, a_out, spec

        # (c) extraction: two folders (and an empty one, skipped), fp32 and float16
        folders = {"empty": root / "empty"}
        folders["empty"].mkdir()
        for split, n in SPLIT_WAVS.items():
            folders[split] = root / split
            folders[split].mkdir()
            for i in range(n):
                write_wav(folders[split] / f"{split}_{i:03d}.wav",
                          rng.standard_normal(160000).astype(np.float32) * 0.1, 16000)
        t0 = time.perf_counter()
        res32 = extract_splits("beats", beats_file, {k: str(v) for k, v in folders.items()},
                               str(root / "emb32"), batch_size=EXTRACT_BATCH, h5py=h5)
        extract_s = time.perf_counter() - t0
        res16 = extract_splits("beats", beats_file, {k: str(v) for k, v in folders.items()},
                               str(root / "emb16"), batch_size=EXTRACT_BATCH, dtype="float16",
                               h5py=h5)
        require(set(res32) == set(res16) == set(SPLIT_WAVS), "extraction: splits not as asked")
        store_err, half_same = 0.0, True
        for split in SPLIT_WAVS:
            rows, half = read_store(res32[split], h5), read_store(res16[split], h5)
            wavs = sorted(folders[split].glob("*.wav"))
            require(rows["filenames"] == [w.stem for w in wavs], "extraction: filenames")
            for start in range(0, len(wavs), EXTRACT_BATCH):
                chunk = wavs[start : start + EXTRACT_BATCH]
                x = np.zeros((EXTRACT_BATCH, 160000), np.float32)
                x[: len(chunk)] = [read_audio(w, pad_to=160000, test=True)[0] for w in chunk]
                with torch.inference_mode():
                    ref = beats(torch.as_tensor(x, device="cuda"))
                for key in ("frame", "global"):
                    got = torch.as_tensor(rows[f"{key}_embeddings"][start : start + len(chunk)])
                    store_err = max(store_err, rel_err(got, ref[key][: len(chunk)].cpu()))
            for key in ("frame_embeddings", "global_embeddings"):
                half_same &= half[key].dtype == np.float16 and np.array_equal(
                    half[key], rows[key].astype(np.float16))
        print(f"extraction: {sum(SPLIT_WAVS.values())} clips in {len(SPLIT_WAVS)} splits (an "
              f"empty folder skipped) at batch {EXTRACT_BATCH} in {extract_s:.2f} s; rows "
              f"against the forward of the same batches {store_err:.3e} (tol {TOL_STORE}); "
              f"the float16 stores equal the fp32 stores' cast: {half_same}", flush=True)
        require(store_err <= TOL_STORE, "extraction: stored rows differ from the forward")
        require(half_same, "extraction: the float16 store is not the fp32 store's cast")
        out["extraction"] = dict(clips=sum(SPLIT_WAVS.values()), s=extract_s,
                                 store_err=store_err, float16_cast=half_same)

        # the 2024 recipe (bf16, fast_dev_run) from stores extracted here
        corpus = root / "corpus"
        write_corpus(corpus, np.random.default_rng(19), RECIPE_CLIPS, "beats", 496, maestro=True)
        config = year_config(ROOT / "recipes" / "dcase2024_task4_baseline" / "confs"
                             / "pretrained.yaml", corpus)
        config["training"]["log_every"] = 1  # every step's loss in metrics.csv
        data = config["data"]
        splits = {split: data[key] for split, key in EXTRACT_SPLITS if data.get(key)}
        probe = corpus / "embeddings" / "beats" / "weak_train.hdf5"
        t0 = time.perf_counter()
        stores = extract_splits("beats", beats_file, splits, str(corpus / "embeddings"),
                                batch_size=32, dtype="float16", h5py=h5)
        corpus_extract_s = time.perf_counter() - t0
        require(set(stores) == set(splits) and str(probe) in stores.values(),
                "extraction: the recipe's stores were not all written")
        weak = read_store(probe, h5)
        first = sorted((corpus / "weak").glob("*.wav"))[0]
        with torch.inference_mode():
            ref = beats(torch.as_tensor(read_audio(first, pad_to=160000, test=True)[0][None],
                                        device="cuda"))["frame"][0].cpu().numpy()
        row = weak["frame_embeddings"][weak["filenames"].index(first.stem)].astype(np.float32)
        row_err = float(np.abs(row - ref).max()) / max(1.0, float(np.abs(ref).max()))
        info = {}
        _build.reset_launches()
        t0 = time.perf_counter()
        _, res = single_run(config, str(corpus / "run"), fast_dev_run=True, fast=True,
                            run_info=info)
        run_s = time.perf_counter() - t0
        with open(corpus / "run" / "metrics.csv") as f:
            losses = [float(r["value"]) for r in csv.DictReader(f) if r["name"] == "train/loss"]
        steps = sum(h["steps"] for h in info["loop"].history)
        numbers = {k: v for k, v in res.items() if isinstance(v, float)}
        n_rows = sum(len(read_store(p, h5)["filenames"]) for p in stores.values())
        print(f"recipe from extracted stores: {len(stores)} stores ({n_rows} rows, float16) in "
              f"{corpus_extract_s:.2f} s; a weak clip's stored row against "
              f"its forward alone {row_err:.3e} (float16); single_run fast_dev_run bf16: "
              f"{steps} steps, losses {losses}, {run_s:.1f} s", flush=True)
        require(row_err <= 2.0 ** -10, "extraction: a stored row is not its clip's embedding")
        require(steps > 0 and len(losses) == steps and all(math.isfinite(v) for v in losses),
                "recipe from extracted stores: not finite losses")
        require(all(0 <= v <= 1 for v in numbers.values()), "recipe: a metric not in [0, 1]")
        out["recipe"] = dict(stores=len(stores), extract_s=corpus_extract_s, row_err=row_err,
                             steps=steps, losses=losses, run_s=run_s)

        del weak
        if h5 is MemoryH5:
            MemoryH5.files.clear()

        # (d) BEATs inside the 2024 train step, fp32 and bf16
        cfg = mean_teacher_2024()
        batch = {}
        for sl in cfg.slots:
            batch[sl.name] = {
                "audio": torch.as_tensor(rng.standard_normal((sl.size, 160000), np.float32)
                                         * 0.05, device="cuda"),
                "labels": torch.as_tensor((rng.random((sl.size, 27, 156)) > 0.95)
                                          .astype(np.float32), device="cuda"),
                "class_mask": torch.ones((sl.size, 27), dtype=torch.bool, device="cuda")}
        init = {k: v.clone() for k, v in randomize(crnn_2024(), gen).state_dict().items()}
        tx, sched = make_optimizer(lr=1e-3, rampup_steps=1000)
        embed = frame_embedder(beats)
        frozen = {k: v.clone() for k, v in beats.state_dict().items()}
        e2e = {}
        for mode, want in (("fp32", STEP_LAUNCHES), ("bf16", STEP16_LAUNCHES)):
            bf16 = mode == "bf16"
            step = make_train_step(cfg, tx, sched, embedder=embed, mel_cfg=MelConfig(
                compute_dtype="bfloat16" if bf16 else "float32"))

            def fresh(kernels=True):
                kw = {"compute_dtype": torch.bfloat16} if bf16 else {}
                model = crnn_2024(**kw) if kernels else crnn_2024(
                    fused_blocks=False, rnn_kernel=False, **kw)
                model.load_state_dict(init)
                return create_state(model, cfg, tx, device="cuda")

            def run(state, seed=7):
                metrics = step(state, batch, torch.Generator(device="cuda").manual_seed(seed))
                torch.cuda.synchronize()
                return ({k: float(v) for k, v in metrics.items()},
                        [p.grad.clone() for p in state.student.parameters()])

            state = fresh()
            torch.cuda.reset_peak_memory_stats()
            _build.reset_launches()
            metrics, grads = run(state)
            launches = dict(_build.LAUNCHES)
            peak = torch.cuda.max_memory_allocated()
            _, grads2 = run(fresh())
            same = all(torch.equal(a, b) for a, b in zip(grads, grads2))
            unchanged = all(torch.equal(v, frozen[k]) for k, v in beats.state_dict().items())
            no_grad = all(p.grad is None for p in beats.parameters())
            print(f"e2e step {mode} (BEATs in the step, 60 clips, no embeddings in the batch): "
                  f"launches {launches}, expected {want}; rerun gradients bitwise equal: "
                  f"{same}; BEATs weights bitwise unchanged, no gradient: "
                  f"{unchanged and no_grad}",
                  flush=True)
            require(launches == want, f"e2e step {mode}: launches differ from phase 8's")
            require(all(math.isfinite(v) for v in metrics.values()), f"e2e {mode}: non-finite")
            require(same, f"e2e step {mode}: gradients not bitwise repeatable")
            require(unchanged and no_grad, f"e2e step {mode}: the embedder's weights moved")
            row = dict(launches=launches, metrics=metrics, bitwise_repeat=same, peak_bytes=peak)
            if not bf16:  # against the same step through the plain versions (phase 8's limits)
                p_metrics, p_grads = run(fresh(kernels=False))
                loss_err = max(abs(metrics[k] - p_metrics[k]) / max(abs(p_metrics[k]), 1e-6)
                               for k in metrics)
                grad_err = max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-3)
                               for a, b in zip(grads, p_grads))
                print(f"e2e step fp32 vs the plain step: metrics {loss_err:.3e} "
                      f"(tol {TOL_LOSS}), gradients {grad_err:.3e} (tol {TOL_GRAD})", flush=True)
                require(loss_err <= TOL_LOSS and grad_err <= TOL_GRAD,
                        "e2e step fp32: disagrees with the plain step")
                row.update(metric_rel_err=loss_err, grad_err=grad_err)
            gen_t = torch.Generator(device="cuda").manual_seed(11)
            row["step_ms"] = time_ms(lambda: step(state, batch, gen_t), iters=3, warmup=1)
            print(f"[{card}] e2e step {mode}, {EMB_CLIPS} clips, BEATs in the step: "
                  f"{row['step_ms']:.3f} ms ({EMB_CLIPS / row['step_ms'] * 1e3:.1f} clips/s; "
                  f"peak memory {peak / 2**30:.2f} GiB)", flush=True)
            e2e[mode] = row
            del state
        out["e2e"] = e2e
        del batch
        torch.cuda.empty_cache()

        # (e) serving with BEATs inside the forward
        classes = list(CLASSES_DESED) + [c for c in CLASSES_MAESTRO_REAL
                                         if c not in CLASSES_DESED]
        enc = ManyHotEncoder(classes, 10, 2048, 256, 4, 16000)
        thresholds = tuple(np.arange(1 / 100, 1, 1 / 50))
        model = randomize(crnn_2024(), gen)
        plain = crnn_2024(fused_blocks=False, rnn_kernel=False)
        plain.load_state_dict(model.state_dict())
        kw = dict(median_filter=MEDIAN_2024, thresholds=thresholds, batch_size=BATCH,
                  embedder=embed)
        pipe = InferencePipeline(model, None, enc, **kw)
        pipe_plain = InferencePipeline(plain, None, enc, **kw)
        serve_dir = root / "serve"
        serve_dir.mkdir()
        wavs = []
        for i in range(N_CLIPS):
            wavs.append(serve_dir / f"clip_{i:04d}.wav")
            write_wav(wavs[-1], rng.standard_normal(160000).astype(np.float32) * 0.1, 16000)
        n_batches = -(-N_CLIPS // BATCH)
        _build.reset_launches()
        t0 = time.perf_counter()
        scores, weak_s, _ = pipe.run(wavs)
        serve_s = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
        per_batch = {k: v // n_batches for k, v in launches.items()}
        scores_p, _, _ = pipe_plain.run(wavs)
        s_err = max(float(np.abs(scores[k] - scores_p[k]).max()) for k in scores)
        print(f"serving with BEATs inside: {N_CLIPS} clips in {n_batches} batches, "
              f"{serve_s:.3f} s wall; launches {launches} ({per_batch} a batch); scores "
              f"against the plain forward {s_err:.3e} (tol {TOL_SCORES})", flush=True)
        require(launches == {"conv_bn_stats": 7 * n_batches, "glu_drop_pool": 7 * n_batches,
                             "bigru": n_batches}, "serving with BEATs: launches")
        require(s_err <= TOL_SCORES, "serving with BEATs: scores differ from the plain forward")
        a64 = audio[:BATCH] if BATCH <= EMB_CLIPS else torch.cat([audio, audio])[:BATCH]
        with torch.inference_mode():
            fwd_ms = time_ms(lambda: pipe.forward(a64), iters=3, warmup=1)
        print(f"[{card}] serving forward with BEATs, batch {BATCH}: {fwd_ms:.3f} ms", flush=True)
        out["serving"] = dict(launches=launches, per_batch=per_batch, score_err=s_err,
                              wall_s=serve_s, forward_ms=fwd_ms)
        del pipe, pipe_plain, model, plain

        # (f) BEATs pretraining at the full config, then the weak fine-tune
        pre_dir = root / "pretrain"
        pre_dir.mkdir()
        pre_wavs = []
        for i in range(PRETRAIN_WAVS):
            pre_wavs.append(pre_dir / f"p_{i:03d}.wav")
            write_wav(pre_wavs[-1], rng.standard_normal(160000).astype(np.float32) * 0.1, 16000)
        pcfg = BEATsPretrainConfig(batch_size=8, steps=PRETRAIN_STEPS, warmup_steps=2)
        info = {}
        t0 = time.perf_counter()
        pre = pretrain_beats(pre_wavs, root / "beats_pretrained.pt", pcfg, verbose=False,
                             run_info=info)
        pre_s = time.perf_counter() - t0
        count = round(pcfg.mask_ratio * tokens)
        masks_ok = all(c == count for row in info["masked"] for c in row)
        labels = (rng.random((PRETRAIN_WAVS, 10)) > 0.7).astype(np.float32)
        info_f = {}
        fine = finetune_beats_weak(pre_wavs, labels, root / "beats_finetuned.pt", pre,
                                   dataclasses.replace(pcfg, steps=FINETUNE_STEPS),
                                   verbose=False, run_info=info_f)
        loaded = build_embedder("beats", fine)
        with torch.inference_mode():
            e = loaded(audio[:2])["frame"]
        step_ms = 1e3 * float(np.median(info["step_s"][1:]))
        print(f"[{card}] BEATs pretraining, full config, batch 8: losses {info['losses']}, "
              f"{count} of {tokens} tokens masked a clip in every step: {masks_ok}; "
              f"{step_ms:.3f} ms a step (median after the first; {pre_s:.1f} s with the "
              f"decode); fine-tune losses {info_f['losses']}; the saved file loads through "
              f"build_embedder and embeds {tuple(e.shape)}", flush=True)
        require(all(math.isfinite(v) for v in info["losses"] + info_f["losses"]),
                "pretraining: non-finite loss")
        require(masks_ok, "pretraining: the mask did not take round(0.6 n) tokens a clip")
        require(tuple(e.shape) == (2, 768, 496) and bool(torch.isfinite(e).all()),
                "pretraining: the saved encoder does not embed")
        out["pretrain"] = dict(losses=info["losses"], step_ms=step_ms, s=pre_s,
                               finetune_losses=info_f["losses"], masked=count)
        del loaded, beats, audio
        torch.cuda.empty_cache()

    out["phase_s"] = time.perf_counter() - t_phase
    print(f"[{card}] phase 13 {out['phase_s']:.1f} s", flush=True)
    report["embedders"] = out
    return {"e2e_beats": out["e2e"]["fp32"]["launches"],
            "e2e_beats_bf16": out["e2e"]["bf16"]["launches"],
            "serve_beats": out["serving"]["per_batch"]}


# ---------------------------------------------------------------------------
# phase 14: parallelism on the card (desed_task_tpu_torch/parallel). The
# card's machine has one card: the multi-rank paths run as ranks that share
# cuda:0 over gloo (NCCL refuses two ranks on one device), so they measure
# correctness and the collectives' cost, not scaling; NCCL runs with one rank.
PAR_RANKS = 2
TP_CLIPS = 8  # clips of the tensor-parallel BEATs' forward against the full one
TOL_TP = 1e-5  # TP BEATs against the full forward, of max(1, max |full|)
EVAL_LAUNCHES = {"conv_bn_stats": 7, "glu_drop_pool": 7, "bigru": 1}  # a batch a pass


def state_digest(state) -> str:
    """sha256 over both models' state dicts (parameters and BN statistics)
    and the Adam moments: equal digests are bitwise-equal replicas."""
    import hashlib

    h = hashlib.sha256()
    for m in (state.student, state.teacher):
        for v in m.state_dict().values():
            h.update(v.detach().cpu().numpy().tobytes())
    for t in state.opt_state["mu"] + state.opt_state["nu"]:
        h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def step_errors(metrics, grads, ref_metrics, ref_grads) -> tuple[float, float]:
    """Phase 7's measures: metrics relative, each gradient of max(max |ref|, 1e-3)."""
    loss_err = max(abs(metrics[k] - ref_metrics[k]) / max(abs(ref_metrics[k]), 1e-6)
                   for k in metrics)
    grad_err = max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-3)
                   for a, b in zip(grads, ref_grads))
    return loss_err, grad_err


def world_one(ctx, report):
    """Phase 14 (a): make_train_step_sharded on {"data": 1} over NCCL, from
    phase 8's state and batch, against make_train_step: two steps, bitwise."""
    import torch
    import torch.distributed as dist

    from desed_task_tpu_torch.parallel import init_distributed, make_mesh
    from desed_task_tpu_torch.recipes_config import crnn_2024
    from desed_task_tpu_torch.training import create_state, make_train_step, make_train_step_sharded

    cfg, tx, sched, batch, init = (ctx[k] for k in ("cfg", "tx", "sched", "batch", "init"))
    with tempfile.TemporaryDirectory(prefix="nccl_") as tmp:
        init_distributed("nccl", (Path(tmp) / "rendezvous").as_uri(), rank=0, world_size=1,
                         timeout_s=120)
        try:
            mesh = make_mesh({"data": 1})
            runs = []
            for step in (make_train_step(cfg, tx, sched),
                         make_train_step_sharded(cfg, tx, sched, mesh, batch)):
                model = crnn_2024()
                model.load_state_dict(init)
                state = create_state(model, cfg, tx, device="cuda")
                gen = torch.Generator(device="cuda").manual_seed(7)
                got = []
                for _ in range(2):
                    metrics = step(state, batch, gen)
                    got.append(({k: float(v) for k, v in metrics.items()},
                                [p.grad.clone() for p in state.student.parameters()],
                                state_digest(state)))
                runs.append(got)
        finally:
            dist.destroy_process_group()
    same = all(m0 == m1 and d0 == d1 and all(torch.equal(a, b) for a, b in zip(g0, g1))
               for (m0, g0, d0), (m1, g1, d1) in zip(*runs))
    print(f"parallel (a): make_train_step_sharded on (data=1) over NCCL against "
          f"make_train_step, 2 steps: metrics, gradients, student, teacher, BN statistics "
          f"and Adam moments bitwise equal: {same}", flush=True)
    require(same, "parallel (a): the one-rank sharded step is not make_train_step bitwise")
    report["parallel"] = {"world_one_bitwise": same}


def _rank_step(rank, world, spec):
    """(b): the 2024 step on the rank's half of phase 7's batch, fp32 and
    bf16, 2 steps each; launches and digests a step, step ms; the three
    all-reduces' sizes timed alone; the fp32 step without its random parts
    against the same step through the plain versions."""
    import dataclasses

    import torch

    from desed_task_tpu_torch.ops import _build
    from desed_task_tpu_torch.ops.frontend import MelConfig
    from desed_task_tpu_torch.parallel import all_reduce_mean, make_mesh, rank_seed, replicate
    from desed_task_tpu_torch.parallel import shard_batch
    from desed_task_tpu_torch.recipes_config import crnn_2024, mean_teacher_2024
    from desed_task_tpu_torch.training import create_state, make_optimizer, make_train_step_sharded

    mesh = make_mesh({"data": world})
    cfg = mean_teacher_2024()
    batch = train_batch(cfg, np.random.default_rng(1))
    shard = to_card(shard_batch(batch, mesh))
    tx, sched = make_optimizer(lr=1e-3, rampup_steps=1000)

    def fresh(config, **kw):
        model = crnn_2024(**kw)
        model.load_state_dict(spec["train_init"])
        state = create_state(model, config, tx, device="cuda")
        replicate([state.student, state.teacher], mesh)
        return state

    out = {}
    for mode in ("fp32", "bf16"):
        bf16 = mode == "bf16"
        state = fresh(cfg, **({"compute_dtype": torch.bfloat16} if bf16 else {}))
        step = make_train_step_sharded(cfg, tx, sched, mesh, batch, mel_cfg=MelConfig(
            compute_dtype="bfloat16" if bf16 else "float32"))
        gen = torch.Generator(device="cuda").manual_seed(rank_seed(7, rank, world))
        launches, digests, losses = [], [], []
        for _ in range(2):
            _build.reset_launches()
            metrics = step(state, shard, gen)
            torch.cuda.synchronize()
            launches.append(dict(_build.LAUNCHES))
            digests.append(state_digest(state))
            losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            metrics = step(state, shard, gen)
            float(metrics["loss"])  # the loop's one fetch a step
        torch.cuda.synchronize()
        out[mode] = dict(launches=launches, digests=digests, losses=losses,
                         step_ms=(time.perf_counter() - t0) / 5 * 1e3)
        if not bf16:
            n_params = sum(p.numel() for p in state.student.parameters())
            n_stats = sum(b.numel() for m in (state.student, state.teacher)
                          for b in m.buffers() if b.is_floating_point())
        del state

    # the three all-reduces of a step at their sizes, timed alone
    group = mesh.groups["data"]
    flats = [torch.zeros(n, device="cuda") for n in (n_params, n_stats, 6)]
    for _ in range(2):
        for f in flats:
            all_reduce_mean([f], group)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        for f in flats:
            all_reduce_mean([f], group)
    torch.cuda.synchronize()
    out["allreduce"] = dict(ms=(time.perf_counter() - t0) / 10 * 1e3,
                            bytes=4 * (n_params + n_stats + 6), n_params=n_params,
                            n_stats=n_stats)

    # without dropout, dropstep and mixup: kernels against plain versions
    quiet_cfg = dataclasses.replace(cfg, mixup=None)
    quiet = dict(dropout=0.0, dropstep_recurrent=0.0)
    step = make_train_step_sharded(quiet_cfg, tx, sched, mesh, batch)
    got = []
    for kw in (quiet, dict(quiet, fused_blocks=False, rnn_kernel=False)):
        state = fresh(quiet_cfg, **kw)
        _build.reset_launches()
        metrics = step(state, shard, torch.Generator(device="cuda").manual_seed(7))
        torch.cuda.synchronize()
        got.append(({k: float(v) for k, v in metrics.items()},
                    [p.grad.clone() for p in state.student.parameters()],
                    dict(_build.LAUNCHES)))
        del state
    out["errs"] = step_errors(got[0][0], got[0][1], got[1][0], got[1][1])
    out["plain_launches"] = got[1][2]
    torch.cuda.empty_cache()
    return out


def _rank_eval(rank, world, spec):
    """(c): phase 10's clips in a cache row-sharded over the ranks, gathered
    to rank 0; launches of one model pass, its ms."""
    import torch

    from desed_task_tpu_torch.data.device_cache import DeviceEvalCache
    from desed_task_tpu_torch.ops import _build
    from desed_task_tpu_torch.parallel import make_mesh
    from desed_task_tpu_torch.recipes_config import MEDIAN_2024, crnn_2024
    from desed_task_tpu_torch.training.evaluate import _predict_cache_all
    from desed_task_tpu_torch.training.mean_teacher import make_predict_step

    mesh = make_mesh({"data": world})
    items, _, _ = eval_items(eval_encoder(), np.random.default_rng(3))
    model = crnn_2024()
    model.load_state_dict(spec["eval_init"])
    model = model.cuda().eval()
    cache = DeviceEvalCache(items, EVAL_BATCH, n_shards=world)
    cache.upload(mesh=mesh)
    predict = make_predict_step()
    _build.reset_launches()
    scores = _predict_cache_all(predict, model, cache, None, MEDIAN_2024, want_raw=True)
    launches = dict(_build.LAUNCHES)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        _predict_cache_all(predict, model, cache, None, MEDIAN_2024, want_raw=True)
    torch.cuda.synchronize()
    return dict(scores=scores, launches=launches, batches=cache.rows // EVAL_BATCH,
                pass_ms=(time.perf_counter() - t0) / 3 * 1e3)


def _rank_tp(rank, world, spec):
    """(d): BEATs tensor-parallel over (data=1, model=2) on phase 13's
    facsimile weights against its full forward on TP_CLIPS clips; then the
    e2e fp32 step with it inside against the same step with the full BEATs
    (phase 13's e2e step) from the same state."""
    import torch

    from desed_task_tpu_torch.models.beats import BEATsConfig, BEATsModel, init_beats
    from desed_task_tpu_torch.ops import _build
    from desed_task_tpu_torch.parallel import make_mesh, shard_batch
    from desed_task_tpu_torch.parallel.tp import shard_beats
    from desed_task_tpu_torch.recipes_config import crnn_2024, mean_teacher_2024
    from desed_task_tpu_torch.tools.embeddings import frame_embedder
    from desed_task_tpu_torch.training import (create_state, make_optimizer, make_train_step,
                                               make_train_step_sharded)

    mesh = make_mesh({"data": 1, "model": world})
    full = init_beats(BEATsModel(BEATsConfig()), torch.Generator().manual_seed(13)).cuda()
    rng = np.random.default_rng(14)
    audio = torch.as_tensor(rng.standard_normal((TP_CLIPS, 160000), np.float32) * 0.05,
                            device="cuda")
    tp = shard_beats(full, mesh)
    with torch.no_grad():
        ref, got = full(audio)["frame"], tp(audio)["frame"]
        err = float((got - ref).abs().max()) / max(1.0, float(ref.abs().max()))
        full_ms = time_ms(lambda: full(audio), iters=3, warmup=1)
        tp_ms = time_ms(lambda: tp(audio), iters=3, warmup=1)

    cfg = mean_teacher_2024()
    batch = to_card(train_batch(cfg, rng, embeddings=False))
    init = randomize(crnn_2024(), torch.Generator().manual_seed(14)).state_dict()
    tx, sched = make_optimizer(lr=1e-3, rampup_steps=1000)
    runs = []
    for step in (make_train_step(cfg, tx, sched, embedder=frame_embedder(full)),
                 make_train_step_sharded(cfg, tx, sched, mesh, batch,
                                         embedder=frame_embedder(tp))):
        model = crnn_2024()
        model.load_state_dict(init)
        state = create_state(model, cfg, tx, device="cuda")
        _build.reset_launches()
        metrics = step(state, shard_batch(batch, mesh) if runs else batch,
                       torch.Generator(device="cuda").manual_seed(7))
        torch.cuda.synchronize()
        runs.append(({k: float(v) for k, v in metrics.items()},
                     [p.grad.clone() for p in state.student.parameters()],
                     dict(_build.LAUNCHES), state_digest(state)))
        gen = torch.Generator(device="cuda").manual_seed(11)
        step_ms = time_ms(lambda: step(state, batch, gen), iters=2, warmup=1)
        del state
    del full, tp
    torch.cuda.empty_cache()
    return dict(err=err, full_ms=full_ms, tp_ms=tp_ms, launches=runs[1][2],
                errs=step_errors(runs[1][0], runs[1][1], runs[0][0], runs[0][1]),
                digest=runs[1][3], step_ms=step_ms, heads=BEATsConfig().encoder_attention_heads)


def _rank_recipe(rank, world, spec):
    """(e): single_run, fast_dev_run, bf16, on phase 11's corpus (each rank
    writes it from the same seed into a directory of its own), both ranks
    into one log directory; on rank 0 the best checkpoint into a fresh
    state and metrics.csv's losses."""
    import csv

    import torch

    from desed_task_tpu_torch.data import datasets
    from desed_task_tpu_torch.obs.checkpoint import CheckpointManager
    from desed_task_tpu_torch.ops import _build
    from desed_task_tpu_torch.training import create_state, make_optimizer
    from desed_task_tpu_torch.training.single_run import build_model, single_run

    log = Path(spec["recipe_log"])
    with tempfile.TemporaryDirectory(prefix=f"recipe_rank{rank}_") as tmp:
        root = Path(tmp)
        if not write_corpus(root, np.random.default_rng(17), RECIPE_CLIPS, "beats", 496,
                            maestro=True)[2]:
            datasets._EmbeddingStore = InMemoryEmbeddings
        config = year_config(ROOT / "recipes" / "dcase2024_task4_baseline" / "confs"
                             / "pretrained.yaml", root)
        config["training"]["log_every"] = 1
        info = {}
        _build.reset_launches()
        t0 = time.perf_counter()
        state, res = single_run(config, str(log), fast_dev_run=True, fast=True,
                                device="cuda:0", run_info=info)
        run_s = time.perf_counter() - t0
    out = dict(digest=state_digest(state), run_s=run_s, launches=dict(_build.LAUNCHES),
               steps=sum(h["steps"] for h in info["loop"].history),
               results=None if res is None else {k: v for k, v in res.items()
                                                 if isinstance(v, float)})
    if rank == 0:
        tx, _ = make_optimizer(1e-3, 1)
        fresh = create_state(build_model(config, fast=True), None, tx, device="cuda:0")
        CheckpointManager(log / "checkpoints").restore("best", fresh)
        out["reload_bitwise"] = state_digest(fresh) == out["digest"]
        with open(log / "metrics.csv") as f:
            out["losses"] = [float(r["value"]) for r in csv.DictReader(f)
                             if r["name"] == "train/loss"]
        out["files"] = sorted(p.name for p in (log / "checkpoints").iterdir())
    return out


def _parallel_rank(rank, world, spec):
    """One rank of phase 14 (b)-(e) on cuda:0, in the order the phase reads them."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False  # as main() sets it
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    out, t0 = {}, time.perf_counter()
    for name, part in (("step", _rank_step), ("eval", _rank_eval), ("tp", _rank_tp),
                       ("recipe", _rank_recipe)):
        out[name] = part(rank, world, spec)
        if rank == 0:
            print(f"parallel: rank 0 done with {name} at {time.perf_counter() - t0:.1f} s",
                  flush=True)
    return out


def eval_encoder():
    from desed_task_tpu_torch.labels.encoder import ManyHotEncoder
    from desed_task_tpu_torch.utils.classes_dict import CLASSES_DESED, CLASSES_MAESTRO_REAL

    classes = list(CLASSES_DESED) + [c for c in CLASSES_MAESTRO_REAL if c not in CLASSES_DESED]
    return ManyHotEncoder(classes, 10, 2048, 256, 4, 16000)


def parallelism(card, report, ctx):
    """Phase 14: (a) in this process over NCCL, (b)-(e) on PAR_RANKS gloo ranks
    that share cuda:0 (parallel/launch.spawn_ranks, 120-s deadline)."""
    import torch

    from desed_task_tpu_torch.data.device_cache import DeviceEvalCache
    from desed_task_tpu_torch.parallel.launch import spawn_ranks
    from desed_task_tpu_torch.recipes_config import MEDIAN_2024, crnn_2024
    from desed_task_tpu_torch.training.evaluate import _predict_cache_all
    from desed_task_tpu_torch.training.mean_teacher import make_predict_step

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()  # the earlier phases' cached blocks, for the ranks
    world_one(ctx, report)
    eval_model = randomize(crnn_2024(), torch.Generator().manual_seed(10))
    spec = dict(train_init=ctx["init"], eval_init=eval_model.state_dict())
    with tempfile.TemporaryDirectory(prefix="parallel_recipe_") as log:
        spec["recipe_log"] = log
        t0 = time.perf_counter()
        ranks = spawn_ranks(_parallel_rank, PAR_RANKS, args=(spec,), timeout_s=120)
        ranks_s = time.perf_counter() - t0
    out = report["parallel"]
    out["ranks_s"] = ranks_s

    # (b) the data-parallel step
    st = [r["step"] for r in ranks]
    for mode, want in (("fp32", STEP_LAUNCHES), ("bf16", STEP16_LAUNCHES)):
        launches = [x for r in st for x in r[mode]["launches"]]
        same = all(st[0][mode]["digests"] == r[mode]["digests"] for r in st)
        losses = [r[mode]["losses"] for r in st]
        print(f"parallel (b) {mode}: {PAR_RANKS} ranks x {TRAIN_BATCH // PAR_RANKS} clips, "
              f"2 steps: launches a step on each rank {launches}, expected {want}; replicas "
              f"(student, teacher, BN statistics, Adam moments) bitwise equal after each step: "
              f"{same}; losses {losses}", flush=True)
        require(all(x == want for x in launches), f"parallel (b) {mode}: launches differ")
        require(same, f"parallel (b) {mode}: the replicas differ")
        require(all(math.isfinite(v) for r in losses for v in r), f"parallel (b) {mode}: loss")
    loss_err, grad_err = st[0]["errs"]
    print(f"parallel (b) fp32 without dropout, dropstep and mixup, against the same 2-rank "
          f"step through the plain versions: metrics {loss_err:.3e} (tol {TOL_LOSS}), "
          f"gradients {grad_err:.3e} (tol {TOL_GRAD}); the plain step launched "
          f"{st[0]['plain_launches']}", flush=True)
    require(loss_err <= TOL_LOSS and grad_err <= TOL_GRAD,
            "parallel (b): the sharded step disagrees with its plain version")
    require(all(r["plain_launches"] == {} for r in st), "parallel (b): the plain step launched")
    ar = st[0]["allreduce"]
    print(f"[{card}] parallel (b): step {st[0]['fp32']['step_ms']:.3f} ms fp32, "
          f"{st[0]['bf16']['step_ms']:.3f} ms bf16 ({PAR_RANKS} ranks on one card, "
          f"{TRAIN_BATCH // PAR_RANKS} clips each); the step's three all-reduces "
          f"({ar['bytes']} bytes a rank: {ar['n_params']} gradients, {ar['n_stats']} BN "
          f"statistics, 6 losses; gloo on CUDA tensors) {ar['ms']:.3f} ms alone", flush=True)
    out["step"] = {k: st[0][k] for k in ("fp32", "bf16", "allreduce", "errs")}

    # (c) the sharded eval against the single-card cache
    items, _, _ = eval_items(eval_encoder(), np.random.default_rng(3))
    cache = DeviceEvalCache(items, EVAL_BATCH)
    cache.upload()
    single = _predict_cache_all(make_predict_step(), eval_model.cuda().eval(), cache, None,
                                MEDIAN_2024, want_raw=True)
    ev = [r["eval"] for r in ranks]
    same = all(np.array_equal(a, b) for a, b in zip(ev[0]["scores"], single))
    per_batch = [{k: v // r["batches"] for k, v in r["launches"].items()} for r in ev]
    exact = all(r["launches"] == {k: v * r["batches"] for k, v in EVAL_LAUNCHES.items()}
                for r in ev)
    print(f"parallel (c): {EVAL_CLIPS} clips in a cache row-sharded over {PAR_RANKS} ranks "
          f"({ev[0]['batches']} batches of {EVAL_BATCH} each), gathered to rank 0: raw, "
          f"median-filtered and weak scores bitwise equal to the single-card cache's: {same}; "
          f"launches a batch a model pass {per_batch} (expected {EVAL_LAUNCHES}); rank 1 "
          f"received no scores: {ev[1]['scores'] is None}", flush=True)
    require(same, "parallel (c): the gathered scores differ from the single-card cache's")
    require(exact and ev[1]["scores"] is None, "parallel (c): launches or the gather differ")
    print(f"[{card}] parallel (c): a model pass over the sharded cache {ev[0]['pass_ms']:.3f} ms "
          f"(with the gather)", flush=True)
    out["eval"] = dict(bitwise=same, launches_per_batch=per_batch[0], pass_ms=ev[0]["pass_ms"])

    # (d) the tensor-parallel BEATs
    tp = [r["tp"] for r in ranks]
    print(f"parallel (d): BEATsConfig() ({tp[0]['heads']} heads, 768 wide, 12 layers) over "
          f"(data=1, model={PAR_RANKS}) on {TP_CLIPS} clips: frame embeddings against the full "
          f"forward {[r['err'] for r in tp]} of max(1, max |full|) (tol {TOL_TP}); e2e fp32 "
          f"step with it inside: launches {[r['launches'] for r in tp]} (expected "
          f"{STEP_LAUNCHES}), against the step with the full BEATs from the same state: "
          f"metrics {tp[0]['errs'][0]:.3e} (tol {TOL_LOSS}), gradients {tp[0]['errs'][1]:.3e} "
          f"(tol {TOL_GRAD}); replicas equal: {tp[0]['digest'] == tp[1]['digest']}", flush=True)
    require(all(r["err"] <= TOL_TP for r in tp), "parallel (d): TP BEATs is not the full one")
    require(all(r["launches"] == STEP_LAUNCHES for r in tp), "parallel (d): launches differ")
    require(tp[0]["errs"][0] <= TOL_LOSS and tp[0]["errs"][1] <= TOL_GRAD,
            "parallel (d): the e2e step with TP BEATs disagrees with the full one's")
    require(tp[0]["digest"] == tp[1]["digest"], "parallel (d): the replicas differ")
    print(f"[{card}] parallel (d): BEATs on {TP_CLIPS} clips {tp[0]['full_ms']:.3f} ms whole, "
          f"{tp[0]['tp_ms']:.3f} ms a rank tensor-parallel ({PAR_RANKS} ranks on one card); "
          f"the e2e step with it {tp[0]['step_ms']:.3f} ms", flush=True)
    out["tp"] = {k: tp[0][k] for k in ("err", "full_ms", "tp_ms", "errs", "step_ms")}

    # (e) the recipe on two ranks
    rc = [r["recipe"] for r in ranks]
    r0 = rc[0]
    same = all(r["digest"] == r0["digest"] for r in rc)
    print(f"parallel (e): single_run fast_dev_run bf16 on {PAR_RANKS} ranks: {r0['steps']} steps "
          f"a rank, losses {r0['losses']}, replicas equal {same}, rank 0 alone got test "
          f"results: {r0['results'] is not None and all(r['results'] is None for r in rc[1:])}; "
          f"checkpoint files {r0['files']}, the best reloads bitwise: {r0['reload_bitwise']}; "
          f"launches a rank {[r['launches'] for r in rc]}", flush=True)
    require(len(r0["losses"]) == 4 and all(math.isfinite(v) for v in r0["losses"]),
            "parallel (e): not 4 finite losses")
    require(same and r0["reload_bitwise"], "parallel (e): replicas or the reload differ")
    require(r0["results"] is not None and all(r["results"] is None for r in rc[1:]),
            "parallel (e): the test results are not rank 0's alone")
    require(r0["files"] == ["best", "best.meta.json", "last", "last.meta.json", "manager.json"],
            "parallel (e): checkpoint files")
    print(f"[{card}] parallel (e): single_run {[round(r['run_s'], 3) for r in rc]} s a rank; "
          f"ranks {ranks_s:.1f} s from spawn to join; phase 14 "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    out["recipe"] = dict(run_s=[r["run_s"] for r in rc], losses=r0["losses"],
                         launches=r0["launches"], steps=r0["steps"])
    out["phase_s"] = time.perf_counter() - t_phase
    return {"sharded_step": st[0]["fp32"]["launches"][0],
            "sharded_step_bf16": st[0]["bf16"]["launches"][0],
            "sharded_eval": per_batch[0], "tp_e2e_beats": tp[0]["launches"]}


# phase 15: the quickstart's corpus size (synth 32, synth_val and test 8,
# weak and unlabeled 16 ten-second soundscapes) and its CRNN's GRU depth.
# single_run trains in bf16 (fast=True, as JAX's), so a quickstart step
# launches what phase 8b's does, but the GRU kernels twice: the 2024 CRNN
# has one GRU layer, the quickstart's two
QS_TRAIN = 32
QS_STEP = {k: v * (2 if k.startswith("bigru") else 1) for k, v in STEP16_LAUNCHES.items()}
QS_TRACED_STEPS = 3
HPO_SEED = 21
HPO_TRIALS = 2
# the CPU op or autograd node inside which each row's kernels launch: the
# forward custom ops and the backward Functions' nodes
ROW_SPANS = {"conv_bn_stats": "desed_torch::conv_bn_stats",
             "glu_drop_pool": "desed_torch::glu_drop_pool",
             "bigru": "desed_torch::bigru",
             "conv_bn_stats_bwd": "ConvBnStatsBackward",
             "glu_drop_pool_bwd": "GluDropPoolBackward",
             "bigru_bwd": "BiGRUBackward"}
EXPORT_BATCH = {"conv_bn_stats": 7, "glu_drop_pool": 7, "bigru": 1}
EXPORT16_BATCH = {"conv_bn_stats.bf16": 7, "glu_drop_pool.bf16": 7, "bigru": 1}


def source_kernels() -> set:
    """The names of the hand-written CUDA kernels (__global__ functions) of
    the port's sources."""
    import re

    names = set()
    for src in (ROOT / "desed_task_tpu_torch" / "csrc").glob("*.cu"):
        bounds = r"(?:__launch_bounds__\((?:[^()]|\([^()]*\))*\)\s*)?"
        for m in re.finditer(r"__global__\s+" + bounds + r"void\s+" + bounds + r"(\w+)\s*\(",
                             src.read_text()):
            names.add(m.group(1))
    return names


def trace_row_kernels(path: Path, hand_written: set) -> dict:
    """From a Chrome trace of torch.profiler: for each row, the names of the
    hand-written CUDA kernels launched inside its op or autograd node: a
    host launch call (CUDA runtime or driver API) on the same thread within
    the span, joined to its kernel by the correlation id, or a kernel whose
    "External id" is the op's."""
    import re

    doc = json.loads(path.read_text())
    events = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    kernels = {e["args"]["correlation"]: e["name"] for e in events
               if e.get("cat") == "kernel" and "correlation" in e.get("args", {})}
    # the libraries link the CUDA runtime statically: their launches show
    # as driver calls (cuLaunchKernel), torch's as runtime calls
    launches = [e for e in events if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "aunch" in e["name"] and "correlation" in e.get("args", {})]

    def base(name: str) -> str:
        # demangled: "void (anonymous namespace)::glu_fwd_frag_kernel<4>(...)"
        return next((w for w in re.findall(r"\w+", name) if w in hand_written), "")

    # a kernel also carries the "External id" of the op innermost at its launch
    by_external: dict = {}
    for e in events:
        if e.get("cat") == "kernel" and "External id" in e.get("args", {}):
            by_external.setdefault(e["args"]["External id"], []).append(e["name"])
    out = {row: set() for row in ROW_SPANS}
    for row, span in ROW_SPANS.items():
        for op in (e for e in events if span in e["name"] and e.get("cat") != "kernel"):
            t0, t1 = op["ts"], op["ts"] + op.get("dur", 0)
            names = list(by_external.get(op.get("args", {}).get("External id"), ()))
            for ln in launches:
                if ln["pid"] == op["pid"] and ln["tid"] == op["tid"] and t0 <= ln["ts"] <= t1:
                    names.append(kernels.get(ln["args"]["correlation"], ""))
            out[row] |= {base(n) for n in names} - {""}
    if not all(out.values()):  # what the trace held instead, for the log
        cats: dict = {}
        for e in events:
            cats[e.get("cat")] = cats.get(e.get("cat"), 0) + 1
        print(f"trace: events by category {cats}; launch calls "
              f"{sorted({e['name'] for e in launches})}; hand-written kernels "
              f"{sorted({base(n) for n in kernels.values()} & hand_written)}", flush=True)
    return out


def hpo_objective(config: dict) -> float:
    """Phase 15b's objective, run in each HPO worker process: single_run
    (fast_dev_run) on the card; the worker's launches are written beside
    the study (HPO_SMOKE_DIR). Returns psds1 + intersection_f1_macro, the
    optuna CLI's objective."""
    import os

    import torch

    from desed_task_tpu_torch.ops import _build
    from desed_task_tpu_torch.training.single_run import single_run

    out = Path(os.environ["HPO_SMOKE_DIR"])
    tag = f"worker{os.environ['HPO_WORKER_INDEX']}_{os.getpid()}"
    tag = f"{tag}_{len(list(out.glob(tag + '_*.json')))}"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.reset_launches()
    t0 = time.perf_counter()
    _, results = single_run(config, str(out / tag), fast_dev_run=True)
    (out / f"{tag}.json").write_text(json.dumps(dict(
        launches=dict(_build.LAUNCHES), s=time.perf_counter() - t0,
        card=torch.cuda.get_device_name(0), visible=os.environ.get("CUDA_VISIBLE_DEVICES"))))
    return results["psds1"] + results["intersection_f1_macro"]


def auxiliaries(card, report, step16_launches):
    """Phase 15: the quickstart with a profiled span and the step timer,
    a 2-worker HPO study on the one card, and the exported serving
    pipeline (fp32 and bf16) against the eager one."""
    import itertools
    import os
    import random

    import torch

    from desed_task_tpu_torch.inference.pipeline import InferencePipeline
    from desed_task_tpu_torch.labels.encoder import ManyHotEncoder
    from desed_task_tpu_torch.obs.profiling import TRACE_FILE, StepTimer, trace
    from desed_task_tpu_torch.ops import _build
    from desed_task_tpu_torch.ops.frontend import MelConfig
    from desed_task_tpu_torch.recipes import quickstart_synthetic as qs
    from desed_task_tpu_torch.recipes_config import MEDIAN_2024, crnn_2024
    from desed_task_tpu_torch.tools import hpo
    from desed_task_tpu_torch.tools.export import export_pipeline, graph_ops, load_pipeline
    from desed_task_tpu_torch.utils.classes_dict import CLASSES_DESED, CLASSES_MAESTRO_REAL

    out = {}
    by_path = {}
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        # (a) the quickstart: soundbank and soundscapes from its seeds, one
        # epoch through single_run on the card, every step's loss logged
        want_step = {k: v * QS_STEP[k] // STEP16_LAUNCHES[k] for k, v in step16_launches.items()}
        info = StepLaunches()
        t0 = time.perf_counter()
        _, results = qs.main(["--workdir", str(root / "qs"), "--n_train", str(QS_TRAIN),
                              "--epochs", "1"], training={"log_every": 1}, run_info=info)
        qs_s = time.perf_counter() - t0
        steps = list(info.steps)
        print(f"quickstart: {QS_TRAIN} training soundscapes, 1 epoch in {qs_s:.3f} s "
              f"(generation included); launches a step {steps}, expected {want_step}", flush=True)
        require(len(steps) >= 1 and all(x == want_step for x in steps),
                "quickstart: a train step's launches differ from phase 8b's")
        with open(root / "qs" / "exp" / "metrics.csv") as f:
            import csv

            rows = list(csv.DictReader(f))
        losses = [float(r["value"]) for r in rows if r["name"] == "train/loss"]
        numbers = {k: v for k, v in results.items() if isinstance(v, float)}
        print(f"quickstart: losses {losses}; test battery " + ", ".join(
            f"{k} {v:.6f}" for k, v in sorted(numbers.items())), flush=True)
        require(len(losses) == len(steps) and all(math.isfinite(v) for v in losses),
                "quickstart: a loss is missing or not finite")
        require(all(math.isfinite(v) and 0 <= v <= 1 for v in numbers.values()),
                "quickstart: a test metric is not finite in [0, 1]")
        # three more steps of its loop under the profiler, timed by StepTimer
        loop = info["loop"]
        batches = itertools.chain.from_iterable(loop._batches() for _ in itertools.count())
        step_batches = [next(batches) for _ in range(QS_TRACED_STEPS)]
        timer = StepTimer(sync_every=QS_TRACED_STEPS, device="cuda").start()
        with trace(root / "trace"):
            for b in step_batches:
                loop.step_fn(loop.state, b, loop.rng)
                timer.step()
        tr_path = root / "trace" / TRACE_FILE
        named = trace_row_kernels(tr_path, source_kernels())
        print(f"quickstart trace ({tr_path.stat().st_size} bytes, {QS_TRACED_STEPS} steps): "
              + "; ".join(f"{row}: {sorted(n)}" for row, n in named.items()), flush=True)
        if not all(named.values()):
            import shutil

            (ROOT / "chiprun_out").mkdir(exist_ok=True)
            shutil.copy(tr_path, ROOT / "chiprun_out" / "quickstart_trace.json")
        require(all(named.values()), "the quickstart trace does not name every row's kernels")
        print(f"[{card}] quickstart StepTimer (sync every {QS_TRACED_STEPS} steps, traced): "
              f"{timer.stats}", flush=True)
        require(len(timer.times) == 1, "StepTimer did not time its cadence")
        out["quickstart"] = dict(s=qs_s, steps=len(steps), launches=steps[0], losses=losses,
                                 metrics=numbers, trace_kernels={k: sorted(v) for k, v in
                                                                 named.items()},
                                 step_timer=timer.stats)
        by_path["quickstart"] = steps[0]

        # (b) HPO: 2 trials, 2 workers sharing the card, on (a)'s corpus
        config = qs.make_config(root / "qs", 1)
        config["training"]["log_every"] = 1
        study = root / "hpo"
        study.mkdir()
        env = {"CUDA_VISIBLE_DEVICES": "0", "HPO_SMOKE_DIR": str(study),
               "PYTHONPATH": os.pathsep.join(
                   p for p in (str(ROOT), os.environ.get("PYTHONPATH")) if p)}
        t0 = time.perf_counter()
        best = hpo.run_study(config, None, HPO_TRIALS, str(study / "log"), mode="train",
                             seed=HPO_SEED, n_workers=2, objective_spec="chip_smoke:hpo_objective",
                             worker_envs=[env] * 2)
        hpo_s = time.perf_counter() - t0
        recs = [json.loads(line) for line in
                (study / "log" / "study_train.jsonl").read_text().splitlines() if line]
        workers = {p.stem: json.loads(p.read_text()) for p in study.glob("worker*.json")}
        print(f"[{card}] hpo: {len(recs)} trials by 2 workers on one card in {hpo_s:.3f} s; "
              f"best {best}; workers " + "; ".join(
                  f"{k}: {v['s']:.3f} s on {v['card']} (CUDA_VISIBLE_DEVICES="
                  f"{v['visible']}), launches {v['launches']}" for k, v in sorted(workers.items())),
              flush=True)
        require(sorted(r["trial"] for r in recs) == list(range(HPO_TRIALS)),
                "hpo: a trial's record is missing")
        # the workers claim trials first-come, so one may run both: every
        # trial's objective run must have left its record on the card
        require(len(workers) == HPO_TRIALS and {r["worker"] for r in recs} <= {"0", "1"},
                "hpo: a trial's objective run left no record")
        for r in recs:
            s_cpu = hpo._RandomSuggest(random.Random(HPO_SEED + r["trial"]))
            hpo.sample_params_train(config, s_cpu)
            require(r["params"] == s_cpu.params, f"hpo: trial {r['trial']}'s parameters "
                                                 "differ from the same seed's on the CPU")
            require(math.isfinite(r["value"]), "hpo: a trial's value is not finite")
        require(all(v["visible"] == "0" and all(v["launches"].get(k, 0) > 0
                                                for k in STEP16_LAUNCHES)
                    for v in workers.values()), "hpo: a trial did not launch every kernel")
        out["hpo"] = dict(s=hpo_s, records=recs, workers=workers)
        total = {}
        for v in workers.values():
            for k, n in v["launches"].items():
                total[k] = total.get(k, 0) + n
        by_path["hpo"] = total

    # (c) the flagship serving pipeline exported with its kernels, fp32 and bf16
    classes = list(CLASSES_DESED) + [c for c in CLASSES_MAESTRO_REAL if c not in CLASSES_DESED]
    enc = ManyHotEncoder(classes, 10, 2048, 256, 4, 16000)
    thresholds = tuple(np.arange(1 / 100, 1, 1 / 50))
    rng = np.random.default_rng(15)
    audio = torch.as_tensor(rng.standard_normal((BATCH, 160000)).astype(np.float32) * 0.1,
                            device="cuda")
    emb = torch.as_tensor(rng.standard_normal((BATCH, 768, 496)).astype(np.float32),
                          device="cuda")
    gen = torch.Generator().manual_seed(15)
    model = randomize(crnn_2024(), gen)
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    export_launches = {}
    for tag, net, mel, want in (
            ("fp32", model, MelConfig(), EXPORT_BATCH),
            ("bf16", crnn_2024(compute_dtype=torch.bfloat16), MelConfig(compute_dtype="bfloat16"),
             EXPORT16_BATCH)):
        pipe = InferencePipeline(net, state, enc, mel_cfg=mel, median_filter=MEDIAN_2024,
                                 thresholds=thresholds, batch_size=BATCH, device="cuda")
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            art = export_pipeline(pipe, Path(tmp) / tag, embeddings_shape=(768, 496))
            export_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            fwd, meta = load_pipeline(art)
            load_s = time.perf_counter() - t0
            size = (art / "forward.pt2").stat().st_size
        with torch.inference_mode():
            eager = pipe.forward(audio, emb)
        _build.reset_launches()
        loaded = fwd(audio, emb)
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
        same = all(a.shape == b.shape and a.dtype == b.dtype and torch.equal(a, b)
                   for a, b in zip(loaded, eager))
        ms = time_ms(lambda: fwd(audio, emb))
        with torch.inference_mode():
            eager_ms = time_ms(lambda: pipe.forward(audio, emb))
        print(f"export {tag}: crnn_2024 at batch {BATCH}, 768x496 embeddings, {len(thresholds)} "
              f"thresholds: exported in {export_s:.3f} s ({size} bytes), loaded in "
              f"{load_s:.3f} s; graph ops {meta['ops']}; launches a batch {launches}, expected "
              f"{want}; outputs bitwise equal to the eager pipeline: {same}", flush=True)
        print(f"[{card}] export {tag}: exported forward {ms:.3f} ms, eager forward "
              f"{eager_ms:.3f} ms, batch {BATCH}", flush=True)
        require(meta["ops"] == ["desed_torch::conv_bn_stats", "desed_torch::glu_drop_pool"] * 7
                + ["desed_torch::bigru"], f"export {tag}: the graph does not call the kernels' ops")
        require(launches == want, f"export {tag}: the loaded program's launches differ")
        require(same, f"export {tag}: the loaded program differs from the eager pipeline")
        require(meta["device_name"] == torch.cuda.get_device_name(0), "export: device name")
        out[f"export_{tag}"] = dict(export_s=export_s, load_s=load_s, bytes=size, ms=ms,
                                    eager_ms=eager_ms, launches=launches, bitwise=same)
        export_launches.update(launches)
    by_path["export"] = export_launches
    out["s"] = time.perf_counter() - t_phase
    print(f"[{card}] phase 15: {out['s']:.3f} s", flush=True)
    report["auxiliaries"] = out
    return by_path


# the phases `--phases` can pick (each with its lettered sub-phases), and
# those a phase takes its context from
PHASES = ("3", "4", "6", "7", "8b", "9", "10", "11", "12", "13", "14", "15")
NEEDS = {"8b": ("7",), "9": ("4",), "14": ("7",)}


def chosen_phases(argv) -> list:
    """The phases to run: every one by default; with --phases, those named
    and the phases they take their context from, in the script's order."""
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--phases", default=",".join(PHASES),
                        help="comma-separated phases to run after the build (e.g. 15 or "
                             "3,4,15; default: all); a phase's context phases run too")
    names = [p.strip() for p in parser.parse_args(argv).phases.split(",") if p.strip()]
    bad = [p for p in names if p not in PHASES]
    if bad:
        parser.error(f"unknown phases {bad}; choose from {list(PHASES)}")
    todo, stack = set(), list(names)
    while stack:
        p = stack.pop()
        if p not in todo:
            todo.add(p)
            stack.extend(NEEDS.get(p, ()))
    return [p for p in PHASES if p in todo]


def main(argv=None) -> int:
    import torch

    phases = chosen_phases(argv)
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
    report = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
              "phases": phases}
    if len(phases) < len(PHASES):
        print(f"phases: {phases} (of {list(PHASES)})", flush=True)

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
    rows = {}
    serve_launches = serve16_launches = train_launches = train16_launches = {}
    fe_launches = eval_launches = eval16_launches = {}
    recipe_launches = recipe16_launches = year_launches = emb_launches = par_launches = {}
    aux_launches = {}
    fe_rows = []
    if "3" in phases:
        geoms = block_geometries(crnn_2024(), MelConfig(), 160000)
        rows = check_kernels(geoms, gen, report)
        rows.update(check_kernels_bf16(geoms, gen, report, rows))
    if "4" in phases:
        serve_launches, pipe, serve16_launches = serve(gen, report)
    if "6" in phases:
        train_geoms = block_geometries(crnn_2024(), MelConfig(), 160000)
        rows.update(check_bwd_kernels(train_geoms, gen, report))
        rows.update(check_bwd_kernels_bf16(train_geoms, gen, report, rows))
    if "7" in phases:
        train_launches, train_ctx = train(gen, report)
    if "8b" in phases:
        train16_launches = train_bf16(train_ctx, report)
    if "9" in phases:
        fe_launches, fe_rows = frontend(gen, pipe, report)
    if "10" in phases:
        eval_launches, eval16_launches = evaluate(gen, card, report)
    if "11" in phases:
        # phase 8b requires its step's launches to be STEP16_LAUNCHES
        recipe_launches, recipe16_launches = recipe(card, report,
                                                    train16_launches or STEP16_LAUNCHES)
    if "12" in phases:
        year_launches = recipes_2021_2023(card, report)
    if "13" in phases:
        emb_launches = embedders(card, report)
    if "14" in phases:
        par_launches = parallelism(card, report, train_ctx)
    if "15" in phases:
        # phase 8b requires its step's launches to be STEP16_LAUNCHES
        aux_launches = auxiliaries(card, report, train16_launches or STEP16_LAUNCHES)
    # the kernels line's row 7: calls at B=64, fp32 and (its own entry) bf16
    if fe_rows:
        rows["fused_log_mel"] = [r for r in fe_rows
                                 if r["B"] == BATCH and r["dtype"] == "float32"]
        rows["fused_log_mel.bf16"] = [r for r in fe_rows
                                      if r["B"] == BATCH and r["dtype"] == "bfloat16"]

    if "4" in phases:
        fw = report["forward"]
        print(f"[{card}] device forward, batch {BATCH}: {fw['forward_ms']:.3f} ms "
              f"(plain versions {fw['plain_forward_ms']:.3f} ms; front-end + scaler "
              f"{fw['frontend_ms']:.3f} ms, CRNN {fw['model_ms']:.3f} ms)", flush=True)
        fb = report["forward_bf16"]
        print(f"[{card}] device forward bf16, batch {BATCH}: {fb['forward_ms']:.3f} ms "
              f"(front-end + scaler {fb['frontend_ms']:.3f} ms, CRNN {fb['model_ms']:.3f} ms; "
              f"fp32 {fw['forward_ms']:.3f} / {fw['frontend_ms']:.3f} / {fw['model_ms']:.3f} ms)",
              flush=True)
    if "7" in phases:
        tr = report["train"]
        print(f"[{card}] train step, {TRAIN_BATCH} clips, fp32: {tr['step_ms']:.3f} ms "
              f"({tr['clips_per_s']:.1f} clips/s; plain versions {tr['plain_step_ms']:.3f} ms; "
              f"peak memory {tr['peak_bytes'] / 2**30:.2f} GiB)", flush=True)
    if "8b" in phases:
        t16 = report["train_bf16"]
        print(f"[{card}] train step, {TRAIN_BATCH} clips, bf16: {t16['step_ms']:.3f} ms "
              f"({t16['clips_per_s']:.1f} clips/s; peak memory "
              f"{t16['peak_bytes'] / 2**30:.2f} GiB; fp32 {tr['step_ms']:.3f} ms, "
              f"{tr['clips_per_s']:.1f} clips/s)", flush=True)
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
                   "eval_bf16": eval16_launches.get(name, 0),
                   "recipe": {k: v.get(name, 0) for k, v in recipe_launches.items()},
                   "recipe_bf16": {k: v.get(name, 0) for k, v in recipe16_launches.items()},
                   **{path: {k: v.get(name, 0) for k, v in counts.items()}
                      for path, counts in year_launches.items()},
                   **{path: counts.get(name, 0) for path, counts in emb_launches.items()},
                   **{path: counts.get(name, 0) for path, counts in par_launches.items()},
                   **{path: counts.get(name, 0) for path, counts in aux_launches.items()}}
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
    sys.exit(main(sys.argv[1:]))
