"""The traced window: torch.profiler over a few steps or passes, reduced to
device busy time, idle gaps, kernel times by name and the device time
launched under each of the harness's host spans.

The profiler's Chrome trace is written to TMPDIR, read once and deleted.
Device activity is every event of the categories kernel, gpu_memcpy and
gpu_memset. A kernel belongs to the harness span (a `record_function`
named "sedbench.*") whose host interval holds the runtime or driver call
that launched it, matched by the profiler's correlation id. An idle gap
is labelled by the span the host was in when the gap began.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time
from collections import defaultdict

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
SPAN_PREFIX = "sedbench."


def span(name: str):
    """A host span of the harness (a no-op outside a profiled window)."""
    return torch.profiler.record_function(SPAN_PREFIX + name)


def kernel_base_name(name: str) -> str:
    """"void (anonymous namespace)::foo_kernel<bf16, 4>(float const*, ...)"
    -> "foo_kernel": no return type, namespaces, template or call arguments."""
    s = name.replace("(anonymous namespace)", "anonymous")
    depth, out = 0, []
    for ch in s:  # drop template arguments
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif depth == 0:
            out.append(ch)
    s = "".join(out).split("(")[0].strip()
    return s.split()[-1].split("::")[-1] if s else name


class Trace:
    """A reduced trace. Times in seconds; `units` the steps or passes traced."""

    def __init__(self, events: list, units: int, window_s: float):
        self.units = units
        self.window_s = window_s
        spans = sorted((e["ts"], e["ts"] + e["dur"], e["name"][len(SPAN_PREFIX):])
                       for e in events if e.get("cat") == "user_annotation"
                       and e["name"].startswith(SPAN_PREFIX))
        self.spans = spans
        launch_ts = {e["args"]["correlation"]: e["ts"] for e in events
                     if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {})}
        self.device = []  # (start_us, end_us, base name, span or "")
        for e in events:
            if e.get("cat") not in DEVICE_CATS:
                continue
            corr = e.get("args", {}).get("correlation")
            where = self._span_at(launch_ts.get(corr))
            name = kernel_base_name(e["name"]) if e["cat"] == "kernel" else e["cat"]
            self.device.append((e["ts"], e["ts"] + e["dur"], name, where))
        self.device.sort()

    def _span_at(self, ts) -> str:
        if ts is None:
            return ""
        for a, b, name in self.spans:
            if a <= ts <= b:
                return name
        return ""

    def merged(self) -> list[tuple[float, float]]:
        out = []
        for a, b, _, _ in self.device:
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.merged()) * 1e-6

    def time_s(self, names=None, in_span: str | None = None) -> float:
        """Summed device seconds of the activities whose base name contains
        one of `names` (all when None), launched under `in_span` (any when
        None), overlaps not merged."""
        tot = 0.0
        for a, b, name, where in self.device:
            if in_span is not None and where != in_span:
                continue
            if names is not None and not any(n in name for n in names):
                continue
            tot += b - a
        return tot * 1e-6

    def top_ops(self, k: int = 10) -> list:
        by = defaultdict(float)
        for a, b, name, _ in self.device:
            by[name] += (b - a) * 1e-6
        return sorted(([n, s] for n, s in by.items()), key=lambda x: -x[1])[:k]

    def idle_by_span(self, k: int = 10) -> list:
        """Idle seconds between device activities, summed by the host span
        in which each gap began."""
        by = defaultdict(float)
        m = self.merged()
        for (_, end), (start, _) in zip(m, m[1:]):
            by[self._span_at(end) or "outside"] += (start - end) * 1e-6
        return sorted(([n, s] for n, s in by.items()), key=lambda x: -x[1])[:k]


@contextlib.contextmanager
def traced(units_box: list):
    """Profile the block (CPU and, where there is a card, CUDA activity);
    yields a list that receives the Trace. `units_box[0]` is read at the
    end: the steps or passes the block ran."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    out = []
    prof = torch.profiler.profile(activities=acts)
    prof.__enter__()
    t0 = time.perf_counter()
    try:
        yield out
        if cuda:
            torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    finally:
        prof.__exit__(None, None, None)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    out.append(Trace([e for e in events if e.get("ph") == "X"], units_box[0], window_s))
