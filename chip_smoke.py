#!/usr/bin/env python3
"""Start the PyTorch port on one NVIDIA GPU and hold it to its plain versions.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):
  1. the card's name and power limit (nvidia-smi);
  2. build every CUDA kernel of the port from desed_task_tpu_torch/csrc;
  3. each kernel against its plain PyTorch version at the shapes of the 2024
     serving path (B=64): conv_bn_stats and glu_drop_pool at all seven conv
     block geometries (glu_drop_pool with and without dropout bits), bigru
     at T=156, H=192;
  4. serving: ~130 ten-second wavs through InferencePipeline(crnn_2024())
     with seeded random weights and random 768x496 frame embeddings, the
     launch counts of the run (7, 7 and 1 per batch), and the scores against
     the same forward built from the plain versions on the card;
  5. timings (CUDA events): the device forward per batch, each kernel beside
     its bound, its plain version and the library call, where one exists.
Then a `kernels` JSON line, the nvidia-smi line, and the result line
{"ok": true, "device": {...}} last.

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
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
TOL_KERNEL = 1e-4  # max |kernel - plain| / max(1, max |plain|), fp32 sums
TOL_SCORES = 1e-4  # max |kernel forward - plain forward| on sigmoid scores


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


def bound_ms(n_bytes: float, flops: float) -> tuple[float, str]:
    tb, tf = n_bytes / PEAK_BYTES * 1e3, flops / PEAK_FP32_FLOPS * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def rel_err(a, b) -> float:
    return float((a - b).abs().max()) / max(1.0, float(b.abs().max()))


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
    for T, Fq, ci, co, pool in geoms:
        B = BATCH
        x = torch.randn(B, T, Fq, ci, generator=gen).to(dev)
        w = (torch.randn(3, 3, ci, co, generator=gen) / math.sqrt(9 * ci)).to(dev)
        b = (torch.randn(co, generator=gen) * 0.1).to(dev)
        y, s, q = fused_cnn.conv_bn_stats(x, w, b)
        yp, sp, qp = fused_cnn.conv_bn_stats_plain(x, w, b)
        err = max(rel_err(y, yp), rel_err(s, sp), rel_err(q, qp))
        print(f"conv_bn_stats  T={T:3d} F={Fq:3d} {ci:3d}->{co:3d}: "
              f"max err {err:.3e} (tol {TOL_KERNEL})", flush=True)
        require(err <= TOL_KERNEL, "conv_bn_stats disagrees with its plain version")
        M = B * T * Fq
        conv_bytes = 4 * (x.numel() + w.numel() + co + M * co + 2 * Fq * co)
        conv_flops = 2 * 9 * ci * co * M + co * M + 3 * M * co
        x_nchw = x.permute(0, 3, 1, 2)  # channels-last view of the same input
        w_oihw = w.permute(3, 2, 0, 1).contiguous()
        rows["conv_bn_stats"].append(dict(
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
            print(f"glu_drop_pool  T={T:3d} F={Fq:3d} Co={co:3d} pool={pool} {label}: "
                  f"max err {errs[-1]:.3e} (tol {TOL_KERNEL})", flush=True)
            require(errs[-1] <= TOL_KERNEL, "glu_drop_pool disagrees with its plain version")
        P = B * T * Fq
        glu_bytes = 4 * (y.numel() + 2 * Fq * co + co * co + co + z.numel())
        glu_flops = P * (2 * co * co + 8 * co)
        rows["glu_drop_pool"].append(dict(
            geom=[T, Fq, co, *pool], max_abs_err=max(abs_errs), rel_err=max(errs),
            ms=time_ms(lambda: fused_cnn.glu_drop_pool(y, scale_f, bias_f, wg, bg, None, pool=pool)),
            plain_ms=time_ms(lambda: fused_cnn.glu_drop_pool_plain(
                y, scale_f, bias_f, wg, bg, None, pool=pool)),
            library_ms=None, bound=bound_ms(glu_bytes, glu_flops)))
        del x, y, yp, z, zp, bits

    T, H, IN = geoms[-1][0], 192, 128
    Hr = 1.0 / math.sqrt(H)
    xg_f, xg_b = (torch.randn(BATCH, T, 3 * H, generator=gen).to(dev) * 0.5 for _ in range(2))
    wf, wb = ((torch.rand(3 * H, H, generator=gen) * 2 - 1).to(dev) * Hr for _ in range(2))
    bf, bb = ((torch.rand(3 * H, generator=gen) * 2 - 1).to(dev) * Hr for _ in range(2))
    f, r = gru.bigru(xg_f, xg_b, wf, bf, wb, bb)
    fp, rp = gru.bigru_plain(xg_f, xg_b, wf, bf, wb, bb)
    err = max(rel_err(f, fp), rel_err(r, rp))
    print(f"bigru          B={BATCH} T={T} H={H}: max err {err:.3e} (tol {TOL_KERNEL})", flush=True)
    require(err <= TOL_KERNEL, "bigru disagrees with its plain version")
    lib = torch.nn.GRU(IN, H, batch_first=True, bidirectional=True).to(dev)
    x_in = torch.randn(BATCH, T, IN, generator=gen).to(dev)
    gru_bytes = 4 * (2 * xg_f.numel() + 2 * (3 * H * H + 3 * H) + 2 * f.numel())
    gru_flops = 2 * T * BATCH * (2 * 3 * H * H + 12 * H)
    with torch.no_grad():
        rows["bigru"].append(dict(
            geom=[BATCH, T, H], max_abs_err=float(max((f - fp).abs().max(), (r - rp).abs().max())),
            rel_err=err, ms=time_ms(lambda: gru.bigru(xg_f, xg_b, wf, bf, wb, bb)),
            plain_ms=time_ms(lambda: gru.bigru_plain(xg_f, xg_b, wf, bf, wb, bb), iters=3),
            library_ms=time_ms(lambda: lib(x_in)), bound=bound_ms(gru_bytes, gru_flops)))
    report["kernel_rows"] = rows
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
    return launches


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
    launches = serve(gen, report)

    fw = report["forward"]
    print(f"[{card}] device forward, batch {BATCH}: {fw['forward_ms']:.3f} ms "
          f"(plain versions {fw['plain_forward_ms']:.3f} ms; front-end + scaler "
          f"{fw['frontend_ms']:.3f} ms, CRNN {fw['model_ms']:.3f} ms)", flush=True)
    sources = {
        "conv_bn_stats": ("desed_task_tpu_torch/csrc/fused_cnn.cu",
                          "desed_task_tpu/ops/pallas_cnn.py:147"),
        "glu_drop_pool": ("desed_task_tpu_torch/csrc/fused_cnn.cu",
                          "desed_task_tpu/ops/pallas_cnn.py:269"),
        "bigru": ("desed_task_tpu_torch/csrc/gru.cu", "desed_task_tpu/ops/pallas_gru.py:38"),
    }
    kernels = []
    for name, rs in rows.items():
        lib = [r["library_ms"] for r in rs]
        b_ms = sum(r["bound"][0] for r in rs)
        by_ops = sum(r["bound"][0] for r in rs if r["bound"][1] == "operations")
        entry = dict(
            name=name, route="cuda", source=sources[name][0], replaces=sources[name][1],
            launches=launches[name], max_abs_err=max(r["max_abs_err"] for r in rs),
            ms=sum(r["ms"] for r in rs), plain_ms=sum(r["plain_ms"] for r in rs),
            bound_ms=b_ms, bound_by="operations" if by_ops >= b_ms / 2 else "bytes",
            library_ms=None if None in lib else sum(lib),
        )
        kernels.append(entry)
        lib_s = "n/a" if entry["library_ms"] is None else f"{entry['library_ms']:.3f} ms"
        print(f"[{card}] {name}: {entry['ms']:.3f} ms per forward "
              f"({len(rs)} call(s) at B={BATCH}), bound {b_ms:.3f} ms "
              f"({entry['bound_by']}), plain {entry['plain_ms']:.3f} ms, "
              f"library {lib_s}", flush=True)
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
