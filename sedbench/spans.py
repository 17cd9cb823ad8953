"""The program's own spans in a profiled block: device time, idle gaps and
host synchronisations put down to the part of the step or pass that
caused them.

The port names its layers with `record_function` spans "desed.*"
(desed_task_tpu_torch/obs/profiling.span), recorded by the same
torch.profiler as the kernels, so spans and kernels share one clock.
`ProgramSpans` reduces the Chrome trace's complete events, the ones that
sedbench.trace.Trace reads (which keeps the harness's spans alone):

- each device activity (kernel, copy, memset) gets its innermost program
  span: the latest-starting program span on the launching call's own
  thread that holds the launch; if there is none on that thread, the
  latest-starting one open on any thread. A backward kernel launched
  from the autograd engine's thread lands in the span entered there
  ("desed.cnn.bwd"), or else in the one the caller waits in
  ("desed.step.backward");
- each idle gap between merged device activities goes to the innermost
  program span open on any thread when it began;
- each host call that blocks on the device (SYNC_CALLS: the CUDA
  runtime's synchronisations and its copy without "Async") counts once,
  under the innermost program span of its own thread.

    python3 -m sedbench.spans --workload <cell> --seed <n> --seconds <s> [--span-cost]

runs one cell as sedbench.run does (set-up, an untraced window of
--seconds), then profiles the cell's traced block and prints one JSON
object: per step or pass the device busy time, the host's wall time in
the untraced window and in the profiled block, the program's spans,
device time, idle time and syncs by program span, the front end's and
the optimizer/EMA's device time, and the share of the top span's
(desed.step or desed.eval) device time launched under none of its child
spans. --span-cost first times `span()`, with no profiler running and
under one.
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import sys
import tempfile
import time
from collections import defaultdict

PROGRAM_PREFIX = "desed."
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
              "cudaMemcpy")
FRONTEND = ("desed.frontend",)
UPDATE = ("desed.step.optimizer", "desed.step.ema")
TOP = {"train": "desed.step", "eval": "desed.eval"}


class _Spans:
    """Spans (start, end, name) of one or more threads; `innermost(ts)` is
    the latest-starting one that holds ts, "" when none does."""

    def __init__(self, spans):
        self.spans = sorted(spans, key=lambda s: (s[0], -s[1]))  # inner after outer
        self.starts = [s[0] for s in self.spans]
        self.longest = max((b - a for a, b, _ in self.spans), default=0.0)

    def innermost(self, ts) -> str:
        i = bisect.bisect_right(self.starts, ts) - 1
        while i >= 0 and self.spans[i][0] >= ts - self.longest:
            a, b, name = self.spans[i]
            if b >= ts:
                return name
            i -= 1
        return ""


class ProgramSpans:
    """The program's spans of a profiled block and what ran under them.
    Times in seconds."""

    def __init__(self, events: list):
        from .trace import DEVICE_CATS, LAUNCH_CATS, kernel_base_name

        self.spans = sorted((e["ts"], e["ts"] + e["dur"], e["name"], e.get("tid"))
                            for e in events if e.get("cat") == "user_annotation"
                            and e["name"].startswith(PROGRAM_PREFIX))
        by_tid = defaultdict(list)
        for a, b, name, tid in self.spans:
            by_tid[tid].append((a, b, name))
        self._tid = {tid: _Spans(s) for tid, s in by_tid.items()}
        self._any = _Spans([s[:3] for s in self.spans])
        launch = {e["args"]["correlation"]: (e["ts"], e.get("tid")) for e in events
                  if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {})}
        # (start_us, end_us, base name, innermost program span or "", launch_us or None)
        self.device = []
        for e in events:
            if e.get("cat") not in DEVICE_CATS:
                continue
            at = launch.get(e.get("args", {}).get("correlation"))
            name = kernel_base_name(e["name"]) if e["cat"] == "kernel" else e["cat"]
            self.device.append((e["ts"], e["ts"] + e["dur"], name,
                                "" if at is None else self.span_at(*at),
                                None if at is None else at[0]))
        self.device.sort()
        self.syncs = [(e["ts"], e["name"], self.span_at(e["ts"], e.get("tid")))
                      for e in events
                      if e.get("cat") == "cuda_runtime" and e["name"] in SYNC_CALLS]

    def span_at(self, ts, tid=None) -> str:
        """The innermost program span at host time ts: on thread tid first,
        then on any thread; "" outside every span."""
        own = self._tid.get(tid)
        return (own.innermost(ts) if own is not None else "") or self._any.innermost(ts)

    def program_time_s(self, prefixes) -> float:
        """Device seconds launched under spans whose name starts with one of
        `prefixes` (overlaps not merged)."""
        prefixes = tuple(prefixes)
        return 1e-6 * sum(d[1] - d[0] for d in self.device if d[3].startswith(prefixes))

    def device_by_program_span(self, k: int = 10) -> list:
        by = defaultdict(float)
        for a, b, _, where, _ in self.device:
            by[where or "outside"] += (b - a) * 1e-6
        return _top(by, k)

    def idle_by_program_span(self, k: int = 10) -> list:
        """Idle seconds between merged device activities, each gap under the
        innermost program span open on any thread when it began."""
        merged = []
        for a, b, _, _, _ in self.device:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        by = defaultdict(float)
        for (_, end), (start, _) in zip(merged, merged[1:]):
            by[self._any.innermost(end) or "outside"] += (start - end) * 1e-6
        return _top(by, k)

    def syncs_by_program_span(self, k: int = 10) -> list:
        by = defaultdict(int)
        for _, _, where in self.syncs:
            by[where or "outside"] += 1
        return _top(by, k)

    def uncovered_share(self, top: str) -> float | None:
        """Of the device time launched inside a `top` span (on any thread),
        the share whose innermost span is `top` itself: launched under none
        of its child spans. None when nothing was launched inside one."""
        inside = _Spans([s[:3] for s in self.spans if s[2] == top])
        whole = own = 0.0
        for a, b, _, where, launched in self.device:
            if launched is not None and inside.innermost(launched):
                whole += b - a
                own += (b - a) * (where == top)
        return None if whole == 0 else own / whole


def _top(by: dict, k: int) -> list:
    return sorted(([n, v] for n, v in by.items()), key=lambda x: -x[1])[:k]


def span_cost_ns(n: int = 1_000_000, n_profiled: int = 50_000) -> dict:
    """Nanoseconds a `span()` call costs, less an empty loop's: with no
    profiler running the call alone and a whole `with span(...)` block,
    and the block under a running CPU profiler, which records it."""
    import torch

    from desed_task_tpu_torch.obs.profiling import span

    def loop(kind: str, count: int) -> float:
        t = time.perf_counter()
        if kind == "call":
            for _ in range(count):
                span("step.optimizer")
        elif kind == "empty":
            for _ in range(count):
                pass
        else:
            for _ in range(count):
                with span("step.optimizer"):
                    pass
        return (time.perf_counter() - t) / count

    best = {k: min(loop(k, n) for _ in range(5)) for k in ("empty", "call", "with")}
    on = []
    for _ in range(3):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            on.append(loop("with", n_profiled))
    best["with_profiled"] = min(on)
    return {k: 1e9 * (best[k] - best["empty"]) for k in ("call", "with", "with_profiled")}


def profiled(cell) -> tuple[list, int, float]:
    """The cell's traced block (its `trace_units` steps or passes) under
    torch.profiler, CPU and CUDA: (the trace's complete events, units, the
    block's wall seconds up to a synchronisation)."""
    import torch

    units = cell.trace_units()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(units):
            cell.run_unit()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    finally:
        os.unlink(path)
    return events, units, wall


def report(events: list, units: int, kind: str, k: int = 40) -> dict:
    """A profiled block's figures and tables, per step or pass."""
    from .trace import Trace

    tr, ps = Trace(events, units, 0.0), ProgramSpans(events)
    counts = defaultdict(int)
    for _, _, name, _ in ps.spans:
        counts[name] += 1

    def per(rows, scale):
        return [[n, scale * v / units] for n, v in rows]

    return {"busy_ms": 1e3 * tr.busy_s() / units,
            "spans_per_unit": len(ps.spans) / units,
            "span_counts": {n: c / units for n, c in sorted(counts.items())},
            "frontend_ms": 1e3 * ps.program_time_s(FRONTEND) / units,
            "update_ms": 1e3 * ps.program_time_s(UPDATE) / units if kind == "train" else None,
            "uncovered_share": ps.uncovered_share(TOP[kind]),
            "span_device_ms": per(ps.device_by_program_span(k), 1e3),
            "span_idle_ms": per(ps.idle_by_program_span(k), 1e3),
            "span_syncs": per(ps.syncs_by_program_span(k), 1),
            "idle_gaps_ms": per(tr.idle_by_span(), 1e3)}


def main(argv=None) -> int:
    from . import run

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--span-cost", action="store_true")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("sedbench.spans: no CUDA device", file=sys.stderr)
        return 2
    out = {"workload": args.workload, "seed": args.seed,
           "card": torch.cuda.get_device_name(), "power_limit_w": run.power_limit_w()}
    if args.span_cost:
        out["span_cost_ns"] = span_cost_ns()
    files = run.cell_files(args.workload, run.manifest())
    cell = run.make_cell(files, args.seed, "cuda")
    cell.setup()
    win = cell.window(args.seconds)
    out["window_ms"] = 1e3 * win["window_s"] / win["units"]
    events, units, wall = profiled(cell)
    cell.free()
    out.update(units=units, profiled_wall_ms=1e3 * wall / units)
    out.update(report(events, units, cell.kind))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
