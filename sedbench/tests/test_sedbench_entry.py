"""The command as the checker runs it: no result without the card(s) the
cell asks for, nor in a directory that holds only BENCHMARK.json and the
benchmark; on the card, one short run of every cell is correct."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys

import pytest

from sedbench import run

CELLS = [w["name"] for w in run.manifest()["workloads"]]


def _run(cwd, workload, seconds="1", trace="0"):
    return subprocess.run([sys.executable, "-m", "sedbench.run", "--workload", workload,
                           "--seed", "4294967311", "--seconds", seconds, "--trace", trace],
                          cwd=cwd, capture_output=True, text=True, timeout=1200)


def _result(out: str):
    lines = out.strip().splitlines()
    try:
        return json.loads(lines[-1]) if lines else None
    except json.JSONDecodeError:
        return None


def test_no_result_in_a_directory_of_the_benchmark_alone(tmp_path):
    shutil.copy(run.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(run.HERE, tmp_path / "sedbench", ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path, CELLS[0])
    assert out.returncode != 0
    assert _result(out.stdout) is None


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the cells run the port's CUDA kernels")


def test_no_result_without_the_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = _run(run.ROOT, CELLS[0])
    assert out.returncode != 0 and _result(out.stdout) is None


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_a_short_run_on_the_card_is_correct(card, workload):
    out = _run(run.ROOT, workload, seconds="2", trace="1")
    assert out.returncode == 0, out.stderr[-2000:]
    r = _result(out.stdout)
    assert r["correct"], r["checks"]
    assert r["device"]["busy_s"] > 0
