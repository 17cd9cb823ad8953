#!/usr/bin/env python3
"""Time the BiGRU kernels of one tree on the GPU, against their plain versions.

    python3 scripts/time_bigru.py [--root DIR] [--iters 20] [--library]

Imports `desed_task_tpu_torch` from DIR (default: this repository), builds
its kernels, and prints one line each for `bigru` at the
serving batch (B=64) and `bigru_bwd` at the train batch (B=60), T=156,
H=192: the card, the tree, the plan, ms per call (CUDA events, mean of
--iters after 3 warm-ups), us per recurrence step (ms / T) and the max
|kernel - plain| relative to max(1, max |plain|). `--library` also times torch.nn.GRU forward and its cuDNN backward on the same shapes.
To compare two versions of the kernels on one card, unpack each into its
own directory and run them in turns in one call (A, B, B, A):

    for d in A B B A; do python3 scripts/time_bigru.py --root $d; done
"""

from __future__ import annotations

import argparse
import math
import subprocess
import sys
from pathlib import Path

T, H, IN = 156, 192, 128
B_SERVE, B_TRAIN = 64, 60


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--library", action="store_true")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("time_bigru: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, str(Path(args.root).resolve()))
    from desed_task_tpu_torch.ops import _build, gru

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

    def rel(a, b):
        return max(float((x - y).abs().max()) / max(1.0, float(y.abs().max()))
                   for x, y in zip(a, b))

    gen = torch.Generator().manual_seed(0)
    hr = 1.0 / math.sqrt(H)
    inputs = {}
    for B in (B_SERVE, B_TRAIN):
        xg = [torch.randn(B, T, 3 * H, generator=gen).cuda() * 0.5 for _ in range(2)]
        w = [(torch.rand(3 * H, H, generator=gen) * 2 - 1).cuda() * hr for _ in range(2)]
        b = [(torch.rand(3 * H, generator=gen) * 2 - 1).cuda() * hr for _ in range(2)]
        d = [torch.randn(B, T, H, generator=gen).cuda() for _ in range(2)]
        inputs[B] = ((xg[0], xg[1], w[0], b[0], w[1], b[1]), d)

    plan = getattr(gru, "bigru_config", None)
    lay = plan(B_SERVE, T, H)[1] if plan else None
    label = ("stream (no plan)" if plan is None else
             f"{plan(B_SERVE, T, H)[0]}" + (f" C={lay.C} BT={gru.CLUSTER_ROWS}" if lay else ""))
    fa, _ = inputs[B_SERVE]
    err = rel(gru.bigru(*fa), gru.bigru_plain(*fa))
    ms = time_ms(lambda: gru.bigru(*fa))
    print(f"[{card}] {args.root} {label}: bigru B={B_SERVE} T={T} H={H}: {ms:.3f} ms, "
          f"{ms / T * 1e3:.2f} us/step, max err {err:.2e}", flush=True)
    ba, (df, db) = inputs[B_TRAIN]
    f, r = gru.bigru(*ba)
    err = rel(gru.bigru_bwd(*ba, f, r, df, db), gru.bigru_bwd_plain(*ba, f, r, df, db))
    ms = time_ms(lambda: gru.bigru_bwd(*ba, f, r, df, db))
    print(f"[{card}] {args.root} {label}: bigru_bwd B={B_TRAIN} T={T} H={H}: {ms:.3f} ms, "
          f"{ms / T * 1e3:.2f} us/step, max err {err:.2e}", flush=True)

    if args.library:
        lib = torch.nn.GRU(IN, H, batch_first=True, bidirectional=True).cuda()
        x = torch.randn(B_SERVE, T, IN, generator=gen).cuda()
        with torch.no_grad():
            ms = time_ms(lambda: lib(x))
        print(f"[{card}] torch.nn.GRU forward B={B_SERVE}: {ms:.3f} ms", flush=True)
        x = torch.randn(B_TRAIN, T, IN, generator=gen).cuda().requires_grad_()
        y, _ = lib(x)
        gy = torch.randn(y.shape, generator=gen).cuda()
        params = [x, *lib.parameters()]
        ms = time_ms(lambda: torch.autograd.grad(y, params, gy, retain_graph=True))
        print(f"[{card}] torch.nn.GRU backward (cuDNN) B={B_TRAIN}: {ms:.3f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
