"""BENCHMARK.json and the files it names: the contract's shapes, names and
limits, and that every cell finds its configuration, mix, limits and
per-layer readers."""

from __future__ import annotations

import ast
import json
import re
from pathlib import Path

import pytest

from sedbench import run

ROOT = run.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    return run.manifest()


def test_top_level_keys_and_command(bench):
    assert set(bench) == TOP
    assert bench["paths"] == ["sedbench"]
    assert 1 <= len(bench["command"]) <= 32
    assert not any(w.startswith("/") or ".." in w for w in bench["command"])
    assert 1 <= bench["run_seconds"] <= 51 and isinstance(bench["run_seconds"], int)
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_names_units_and_entry_keys(bench):
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in bench[k]]
    assert all(NAME.match(n) for n in names), names
    for k in ("configs", "workloads", "end_to_end", "per_layer"):
        got = [x["name"] for x in bench[k]]
        assert len(got) == len(set(got)), k
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["why"]) and _line(c["source"]) and len(c["reduced"]) <= 16
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("sedbench/")
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _line(w["why"])
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in SOURCES and _line(m["layer"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")


def test_every_cell_has_its_files_and_metrics(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    configs = {c["name"] for c in bench["configs"]}
    used = set()
    for w in bench["workloads"]:
        assert w["config"] in configs
        used.add(w["config"])
        files = run.cell_files(w["name"], bench)
        assert files["config"]["name"] == w["config"]
        assert (run.HERE / "drivers" / f"{files['traffic']['driver']}.py").is_file()
        assert files["cell"]["limits"]
        reported = {n for n, m in e2e.items() if "workloads" not in m or w["name"] in m["workloads"]}
        assert "setup_s" in reported and len(reported) >= 2
        layer = [m for m in bench["per_layer"] if w["name"] in m.get("workloads", [w["name"]])]
        assert layer, w["name"]
        for m in layer:  # a per-layer metric moves an end-to-end metric its cells report
            assert m["moves"] in reported, (m["name"], w["name"])
            assert (run.HERE / "metrics" / f"{m['name']}.py").is_file()
    assert used == configs


def test_config_files_name_every_reduced_key(bench):
    for c in bench["configs"]:
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["source"] == c["source"] and data["reduced"] == c["reduced"]
        assert all(k in data for k in c["reduced"])


def test_layers_are_named_alike(bench):
    by = {}
    for m in bench["per_layer"]:
        by.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in by.values()), by


def test_check_time_fits(bench):
    """2 + 14 x 24 runs of run_seconds + 60 s, 2 x 90 s of compile a cell and
    1200 s spare fit 43200 s, at the most cells a benchmark may have."""
    runs = 2 + 14 * 24
    assert runs * (bench["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_paths_hold_only_the_benchmark():
    tracked = [p for p in (ROOT / "sedbench").rglob("*") if p.is_file()
               and "__pycache__" not in p.parts]
    assert all(re.match(r"^[A-Za-z0-9_./-]+$", str(p.relative_to(ROOT))) for p in tracked)


def test_metric_files_parse():
    for p in (run.HERE / "metrics").glob("*.py"):
        tree = ast.parse(p.read_text())
        assert any(isinstance(n, ast.FunctionDef) and n.name == "read" for n in tree.body), p
