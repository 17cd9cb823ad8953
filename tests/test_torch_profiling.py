"""The port's profiling helpers: `trace` writes a Chrome trace that json
parses, with the traced ops named (the program's spans:
tests/test_torch_spans.py).
"""

import json

import torch

from desed_task_tpu_torch.obs.profiling import TRACE_FILE, trace


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
