"""The port's profiling helpers against desed_task_tpu.obs.profiling.

`trace` writes a Chrome trace that json parses, with the traced ops named;
`StepTimer` on the CPU keeps the JAX timer's cadence (one time a
`sync_every` steps, none when no sync value is given) and its stats keys.
"""

import json

import numpy as np
import pytest
import torch

from desed_task_tpu.obs.profiling import StepTimer as JaxStepTimer
from desed_task_tpu_torch.obs.profiling import TRACE_FILE, StepTimer, trace


def test_trace_writes_a_parseable_chrome_trace(tmp_path):
    a = torch.randn(32, 32)
    with trace(tmp_path / "prof"):
        for _ in range(3):
            a = a @ a.t() / 32.0
    doc = json.loads((tmp_path / "prof" / TRACE_FILE).read_text())
    names = {e.get("name") for e in doc["traceEvents"]}
    assert "aten::mm" in names


def test_trace_default_activities(tmp_path):
    with trace(tmp_path) as prof:
        torch.ones(4).sum()
    assert prof is not None and (tmp_path / TRACE_FILE).is_file()


@pytest.mark.parametrize("sync_every,steps", [(1, 3), (2, 7), (5, 12), (50, 10)])
def test_step_timer_cadence_matches_jax(sync_every, steps):
    ours, theirs = StepTimer(sync_every, device="cpu").start(), JaxStepTimer(sync_every).start()
    for i in range(steps):
        ours.step(torch.tensor(float(i)))
        theirs.step(np.float32(i))
    assert len(ours.times) == len(theirs.times) == steps // sync_every
    assert sorted(ours.stats) == sorted(theirs.stats)
    assert all(t >= 0.0 for t in ours.times)


def test_step_timer_without_sync_value_records_nothing_on_the_cpu():
    ours, theirs = StepTimer(2).start(), JaxStepTimer(2).start()
    for _ in range(6):
        ours.step()
        theirs.step()
    assert ours.times == theirs.times == [] and ours.stats == theirs.stats == {}


def test_step_timer_stats_keys():
    t = StepTimer(1).start()
    t.step(1.0)
    t.step(2.0)
    s = t.stats
    assert set(s) == {"step_time_mean_s", "step_time_p50_s", "step_time_last_s"}
    assert s["step_time_last_s"] == t.times[-1]
