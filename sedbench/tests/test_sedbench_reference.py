"""The plain reference against the program's plain path on the CPU, at a
small size: run in fp32 (the configuration's compute dtype switched off),
the program's checked steps and eval passes equal the reference's to
rounding, which shows that both draw the same masks in the same order from
the same generator and compute the same step."""

from __future__ import annotations

import pytest
import torch

from sedbench import run
from sedbench.tests.small import small_files


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("workload", ["train_2024_bf16", "train_2023_bf16"])
def test_reference_step_equals_the_program_in_fp32(workload):
    files = small_files(workload)
    files["config"]["compute_dtype"] = "float32"
    n = run.run(workload, 2**31 + 7, 0.2, False, "cpu", files=files)["_numbers"]
    assert n["loss_gap"] < 1e-6
    assert n["grad_gap"] < 1e-4
    assert n["grad_gap_median"] < 1e-5
    assert n["change_gap"] < 1e-3  # Adam's change of a leaf near 1: fp32 rounding of it
    assert n["teacher_gap"] < 1e-2


@pytest.mark.parametrize("workload", ["eval_2024_bf16", "eval_2023_bf16"])
def test_reference_eval_equals_the_program_in_fp32(workload):
    files = small_files(workload)
    files["config"]["compute_dtype"] = "float32"
    n = run.run(workload, 2**31 + 8, 0.2, False, "cpu", files=files)["_numbers"]
    assert n["score_gap"] < 1e-5
    assert n["mean_gap"] < 1e-6


@pytest.mark.parametrize("workload", ["train_2023_bf16", "eval_2024_bf16"])
def test_a_run_in_bf16_is_correct_and_reports_its_metrics(workload):
    files = small_files(workload)
    r = run.run(workload, 12345678901, 0.2, True, "cpu", files=files)
    assert r["correct"], r["checks"]
    assert r["_forbidden"] == []
    assert list(r["checks"]) == list(files["cell"]["limits"])
    host = {m["name"] for m in run.manifest()["per_layer"]
            if m["source"] == "host_clock" and workload in m.get("workloads", [workload])}
    assert set(r["metrics"]) == host  # off the card only the host-clock readers read
    assert r["device"]["platform"] == "cpu"
