#!/usr/bin/env python3
"""Where the time of the port's 2024 mean-teacher train step goes, on one
NVIDIA GPU.

    python3 scripts/profile_torch_train.py [--dtype bfloat16]

Builds the step as chip_smoke.py does (crnn_2024() student and teacher from
a seed, mean_teacher_2024(): 60 ten-second clips in slots [12, 6, 6, 12, 24],
768x496 frame embeddings, fp32, the hand-written kernels; with --dtype
bfloat16 bench.py's bf16 step: crnn_2024(compute_dtype=torch.bfloat16) and
MelConfig(compute_dtype="bfloat16")) and prints:
  * the step time as the median and quartiles of 7 timed repeats of 5 steps
    (CUDA events), with clips/s and the card's name and power limit;
  * the host time to issue one step (perf_counter around the call, no
    synchronisation), median of the same steps;
  * a torch.profiler trace of 3 steps: device time by kernel and the
    device's idle share over the traced window (wall time between the first
    and last device activity, minus the summed kernel time);
  * the host calls that wait on the card (synchronisations, device-to-host
    copies, scalar reads, allocations) over 3 traced steps, by the
    package's innermost frame on their call stack (torch.profiler,
    with_stack);
  * where the host's time goes: cProfile over 3 steps (synchronised), the
    functions with the most time of their own.
The full tables go to chiprun_out/profile_torch_train.txt (fp32) or
chiprun_out/profile_torch_train_bf16.txt.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dtype", choices=("float32", "bfloat16"), default="float32")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("profile_torch_train: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from chip_smoke import card_line, randomize
    from desed_task_tpu_torch.ops.frontend import MelConfig
    from desed_task_tpu_torch.recipes_config import crnn_2024, mean_teacher_2024
    from desed_task_tpu_torch.training import create_state, make_optimizer, make_train_step

    card = card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = mean_teacher_2024()
    rng = np.random.default_rng(1)
    dev = torch.device("cuda")
    batch = {s.name: {
        "audio": torch.as_tensor(rng.standard_normal((s.size, 160000), np.float32) * 0.05,
                                 device=dev),
        "labels": torch.as_tensor((rng.random((s.size, 27, 156)) > 0.95).astype(np.float32),
                                  device=dev),
        "embeddings": torch.as_tensor(rng.standard_normal((s.size, 768, 496), np.float32),
                                      device=dev),
    } for s in cfg.slots}
    tx, sched = make_optimizer(lr=1e-3, rampup_steps=1000)
    bf = args.dtype == "bfloat16"
    model = crnn_2024(**({"compute_dtype": torch.bfloat16} if bf else {}))
    state = create_state(randomize(model, torch.Generator().manual_seed(0)), cfg, tx,
                         device="cuda")
    step = make_train_step(cfg, tx, sched, mel_cfg=MelConfig(compute_dtype=args.dtype))
    gen = torch.Generator(device="cuda").manual_seed(3)
    clips = cfg.batch_size

    for _ in range(3):
        step(state, batch, gen)
    torch.cuda.synchronize()
    reps, issue = [], []
    for _ in range(7):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(5):
            t0 = time.perf_counter()
            step(state, batch, gen)
            issue.append((time.perf_counter() - t0) * 1e3)
        end.record()
        end.synchronize()
        reps.append(start.elapsed_time(end) / 5)
    q1, med, q3 = np.percentile(reps, [25, 50, 75])
    print(f"[{card}] {args.dtype} train step of {clips} clips: median {med:.3f} ms, quartiles "
          f"{q1:.3f} / {q3:.3f} ms over {len(reps)} repeats of 5 "
          f"({clips / med * 1e3:.1f} clips/s); host issue time median "
          f"{np.median(issue):.3f} ms per step", flush=True)

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            step(state, batch, gen)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    table = prof.key_averages().table(sort_by="self_device_time_total", row_limit=60)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    txt = out / ("profile_torch_train_bf16.txt" if bf else "profile_torch_train.txt")
    txt.write_text(f"{card}\n{table}\n")
    if not kernels:
        print(f"[{card}] profiler recorded no device time: idle share not measured")
        return 0
    t0 = min(e.time_range.start for e in kernels)
    t1 = max(e.time_range.end for e in kernels)
    window = t1 - t0
    print(f"[{card}] traced 3 steps: device busy {busy_us / 1e3:.3f} ms of a "
          f"{window / 1e3:.3f} ms window, idle share {1 - busy_us / window:.3f}")
    by_name: dict[str, float] = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:30]:
        print(f"  {us / 3e3:9.3f} ms/step  {us / busy_us:6.1%}  {name[:100]}")

    # where the host waits for the card: host-side calls that block (syncs,
    # device-to-host copies, scalar reads, allocations), by the package's
    # innermost frame above them (with_stack records Python frames as events)
    waits = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
             "cudaMemcpy", "cudaMemcpyAsync", "cudaMalloc", "cudaFree",
             "aten::item", "aten::_local_scalar_dense")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 with_stack=True) as prof:
        for _ in range(3):
            step(state, batch, gen)
    torch.cuda.synchronize()
    by_site: dict[tuple[str, str], list] = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CPU or e.name not in waits:
            continue
        # the Python tracer's frames are the event's ancestors, "file(line): fn"
        site, up = "(outside desed_task_tpu_torch)", e.cpu_parent
        while up is not None:
            if "desed_task_tpu_torch" in up.name:
                site = up.name[up.name.index("desed_task_tpu_torch"):]
                break
            up = up.cpu_parent
        acc = by_site.setdefault((e.name, site), [0, 0.0])
        acc[0] += 1
        acc[1] += e.time_range.elapsed_us()
    print(f"[{card}] host calls that wait on the card, over 3 steps (ms per step, calls per "
          "step, innermost frame of the package):")
    for (name, site), (n, us) in sorted(by_site.items(), key=lambda kv: -kv[1][1])[:12]:
        print(f"  {us / 3e3:8.3f} ms/step {n / 3:6.1f} calls/step  {name}  {site}")

    import cProfile
    import io
    import pstats

    host = cProfile.Profile()
    host.enable()
    for _ in range(3):
        step(state, batch, gen)
    torch.cuda.synchronize()
    host.disable()
    buf = io.StringIO()
    stats = pstats.Stats(host, stream=buf).sort_stats("tottime")
    stats.print_stats(25)
    with open(txt, "a") as f:
        f.write(buf.getvalue())
    print(f"[{card}] host, cProfile over 3 steps (own time per step):")
    for (file, line, fn), (_, calls, tt, _, _) in sorted(
            stats.stats.items(), key=lambda kv: -kv[1][2])[:12]:
        print(f"  {tt / 3 * 1e3:8.3f} ms/step {calls / 3:8.1f} calls/step  "
              f"{Path(file).name}:{line} {fn}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
