"""Profiling helpers (counterpart of desed_task_tpu/obs/profiling.py).

- `trace(log_dir)`: a context manager around torch.profiler.profile, CPU
  activity always and CUDA activity when the card is in use. On exit it
  writes a Chrome trace (`trace.json`, viewable in Perfetto or
  chrome://tracing) under `log_dir`; its CUDA events name each kernel.
- `StepTimer`: per-step wall-clock stats at a sync cadence. On the card it
  records a CUDA event a step and waits on one only every `sync_every`
  steps: the JAX timer's single host fetch a cadence, and no other host
  synchronisation. On the CPU it reads time.perf_counter.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path

import numpy as np
import torch

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir):
    """Profile the block; writes `<log_dir>/trace.json`. The card's activity
    is traced too when CUDA is available."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(out / TRACE_FILE))


class StepTimer:
    """start(); step() once a train step; stats: mean, median and last of
    the per-step time over each `sync_every` steps."""

    def __init__(self, sync_every: int = 50, device: str | torch.device | None = None):
        self.sync_every = sync_every
        self.cuda = torch.device(device or "cpu").type == "cuda"
        self.times: list[float] = []
        self._t0 = None
        self._steps = 0

    def _mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def start(self):
        self._t0 = self._mark()
        self._steps = 0
        return self

    def step(self, sync_value=None):
        """Call once per train step. On the CPU `sync_value` (a scalar) is
        read at the cadence, as the JAX timer reads it; on the card the
        cadence's event is waited on instead."""
        self._steps += 1
        if self._steps % self.sync_every:
            return
        now = self._mark()
        if self.cuda:
            now.synchronize()
            dt = self._t0.elapsed_time(now) / 1000.0
        else:
            if sync_value is None:
                return
            float(sync_value)
            now = time.perf_counter()
            dt = now - self._t0
        self.times.append(dt / self._steps)
        self._t0 = now
        self._steps = 0

    @property
    def stats(self) -> dict:
        if not self.times:
            return {}
        arr = np.asarray(self.times)
        return {
            "step_time_mean_s": float(arr.mean()),
            "step_time_p50_s": float(np.median(arr)),
            "step_time_last_s": float(arr[-1]),
        }
