"""The comparison that decides `correct` fails what it must, at a size a
CPU test holds: a run whose timed path is broken underneath (each fault
the cell's kind can have) comes out not correct, and so does the control,
the reference computed one precision below the configuration's (float8
e4m3 for bfloat16), put in the program's place."""

from __future__ import annotations


import pytest
import torch

from sedbench import control, run
from sedbench.drivers import eval as eval_driver
from sedbench.drivers import train as train_driver
from sedbench.tests.small import small_files

CASES = [(w, f) for w in ("train_2024_bf16", "train_2023_bf16") for f in train_driver.FAULTS] + \
    [(w, f) for w in ("eval_2024_bf16", "eval_2023_bf16") for f in eval_driver.FAULTS]


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("workload,fault", CASES)
def test_a_broken_timed_path_is_not_correct(workload, fault):
    files = small_files(workload)
    r = run.run(workload, 3_000_000_019, 0.2, False, "cpu", fault=fault, files=files)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("workload", ["train_2024_bf16", "train_2023_bf16",
                                      "eval_2024_bf16", "eval_2023_bf16"])
def test_the_control_is_not_correct(workload):
    files = small_files(workload)
    got = dict(control.readings(files, 3_000_000_021, "cpu", faults=False, seconds=0.2))
    ok, _ = run.judge(got["program"], files["cell"]["limits"])
    assert ok, got["program"]
    bad, checks = run.judge(got["control"], files["cell"]["limits"])
    assert not bad, checks
