#!/usr/bin/env python3
"""Reproduce the CPU vector-math first-call fault behind the log-mel parity
flakes (ROADMAP.md section 3).

    python3 scripts/probe_cpu_vector_math.py --op sqrt [--settle] [--rounds 40] [--procs 8]

Each round starts --procs processes at once. Each makes one operation's
first call in its process on a tensor large enough to be split across the
OpenMP threads, repeats the call, and reports whether the two results
differ and by how much (relative). --op: sqrt, log, log10 or hypot (torch
on 64,575 float32 values), or log_mel (the port's `fused_log_mel_plain`
and `log_mel_spectrogram` on one second of audio; they settle the vector
math themselves). --settle makes `frontend.settle_cpu_vector_math()` the
process's first call. Prints one line: the operation, --settle, the
number of processes, how many differed, the largest relative gap and the
fewest and most elements that differed in a process where any did.
CPU only; it starts processes, so keep --procs near the core count.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
N = 64575  # a log-mel's magnitudes: 63 frames x 1025 frequencies


def child(op: str, settle: bool) -> dict:
    import numpy as np
    import torch

    if settle or op == "log_mel":
        sys.path.insert(0, str(ROOT))
        from desed_task_tpu_torch.ops import frontend

        if settle:
            frontend.settle_cpu_vector_math()
    if op == "log_mel":
        from desed_task_tpu_torch.ops.fused_mel import fused_log_mel_plain

        audio = torch.from_numpy(
            (np.random.default_rng(1).standard_normal((1, 16000)) * 0.1).astype(np.float32))
        cfg = frontend.MelConfig()
        run = lambda: torch.cat([fused_log_mel_plain(audio, cfg),
                                 frontend.log_mel_spectrogram(audio, cfg)])
    else:
        r = np.random.default_rng(0)
        a = torch.from_numpy((r.random(N) * 10 + 0.1).astype(np.float32))
        b = torch.from_numpy((r.random(N) * 10 + 0.1).astype(np.float32))
        run = {"sqrt": lambda: torch.sqrt(a), "log": lambda: torch.log(a),
               "log10": lambda: torch.log10(a), "hypot": lambda: torch.hypot(a, b)}[op]
    first, again = run(), run()
    gap = ((first.double() - again.double()).abs() / again.double().abs().clamp(min=1e-30))
    return {"differs": not torch.equal(first, again), "rel": float(gap.max()),
            "n_diff": int((first != again).sum()), "numel": first.numel()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--op", choices=["sqrt", "log", "log10", "hypot", "log_mel"], default="sqrt")
    ap.add_argument("--settle", action="store_true")
    ap.add_argument("--rounds", type=int, default=40)
    ap.add_argument("--procs", type=int, default=8)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(child(args.op, args.settle)), flush=True)
        return 0
    cmd = [sys.executable, __file__, "--child", "--op", args.op] + (["--settle"] if args.settle else [])
    n = bad = 0
    worst = 0.0
    n_diff = []
    for _ in range(args.rounds):
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True) for _ in range(args.procs)]
        for p in procs:
            out, _ = p.communicate(timeout=600)
            if p.returncode:
                raise RuntimeError(f"a probe process failed with code {p.returncode}")
            res = json.loads(out.strip().splitlines()[-1])
            n += 1
            bad += res["differs"]
            worst = max(worst, res["rel"])
            if res["differs"]:
                n_diff.append(res["n_diff"])
    print(f"op {args.op}, settle {args.settle}: {n} processes ({args.rounds} rounds of "
          f"{args.procs}), first call differed in {bad}, largest relative gap {worst:.3e}"
          + (f", {min(n_diff)}-{max(n_diff)} of {res['numel']} elements differing" if n_diff
             else ""), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
