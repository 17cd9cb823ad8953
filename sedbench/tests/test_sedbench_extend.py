"""A later change adds a cell, a configuration, a traffic mix, a driver
for a new kind of traffic and a per-layer metric as new files and manifest
entries only: the harness finds them by name, with no edit to a file that
is there."""

from __future__ import annotations

import json
import shutil

import torch

from sedbench import run
from sedbench.tests.small import small_files


def test_new_files_are_found_by_name(tmp_path):
    here = tmp_path / "sedbench"
    shutil.copytree(run.HERE, here, ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in here.rglob("*") if p.is_file()}
    bench = run.manifest()
    files = small_files("eval_2023_bf16")
    cfg = dict(files["config"], name="crnn2023_narrow_test")
    (here / "configs" / "crnn2023_narrow_test.json").write_text(json.dumps(cfg))
    traffic = dict(files["traffic"], driver="eval_twice_test")
    (here / "traffic" / "eval_tiny_test.json").write_text(json.dumps(traffic))
    (here / "drivers" / "eval_twice_test.py").write_text(
        '"""A kind of traffic that counts its set-up twice."""\n\n'
        "from sedbench.drivers.eval import FAULTS, Cell as _Eval, compare  # noqa: F401\n\n\n"
        "class Cell(_Eval):\n"
        "    def end_to_end(self, win, setup_s, trace=None):\n"
        "        out = super().end_to_end(win, setup_s, trace)\n"
        "        return dict(out, setup_s=2 * out['setup_s'])\n")
    (here / "workloads" / "eval_tiny_test.json").write_text(json.dumps(files["cell"]))
    (here / "metrics" / "passes_seen.eval.py").write_text(
        '"""passes_seen.eval: passes in the untraced window."""\n\n\n'
        "def read(ctx):\n    return float(ctx.window['units'])\n")
    bench["configs"].append({"name": "crnn2023_narrow_test", "source": "test",
                             "file": "sedbench/configs/crnn2023_narrow_test.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "eval_tiny_test", "config": "crnn2023_narrow_test",
                               "traffic": "eval_tiny_test", "chips": 1, "why": "test"})
    next(m for m in bench["end_to_end"]
         if m["name"] == "eval_device_ms")["workloads"].append("eval_tiny_test")
    bench["per_layer"].append({"name": "passes_seen.eval", "unit": "passes", "better": "higher",
                               "source": "host_clock", "layer": "eval loop",
                               "moves": "eval_device_ms", "workloads": ["eval_tiny_test"]})
    found = run.cell_files("eval_tiny_test", bench, here)
    assert found["config"]["name"] == "crnn2023_narrow_test"
    assert found["traffic"] == traffic and found["cell"] == files["cell"]
    torch.set_num_threads(2)
    cell = run.make_cell(found, 5, "cpu", here=here)
    assert type(cell).__name__ == "Cell" and type(cell).__module__.endswith("eval_twice_test")
    cell.setup()
    win = cell.window(0.1)
    e2e = run.end_to_end(bench, "eval_tiny_test", cell.end_to_end(win, 1.0))
    assert e2e["setup_s"]["value"] == 2.0
    got = run.per_layer(bench, "eval_tiny_test", run.Context(cell, win, None, found), here)
    assert got["passes_seen.eval"]["value"] == win["units"]
    assert "mfu.eval" not in got  # a metric that lists its cells stays in them
    for p, b in before.items():
        assert p.read_bytes() == b, p
