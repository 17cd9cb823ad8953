"""One run of one benchmark cell of the PyTorch/CUDA port.

    python3 -m sedbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the repository root, on a machine with the card(s) the cell asks for.
The cell is read from BENCHMARK.json; its configuration, traffic mix and
correctness limits from files named after them (configs/<config>.json,
traffic/<traffic>.json, workloads/<cell>.json), the driver of the mix's
kind from drivers/<driver>.py (the mix's "driver" key), each per-layer
metric from metrics/<metric>.py. A new cell, configuration, mix, kind of
traffic or metric is new files and a new entry in BENCHMARK.json, no edit
here.

--trace 0 prints the cell's end-to-end metrics; --trace 1 its per-layer
metrics, read from an untraced window of --seconds and then a profiled
block of a few steps or passes. A cell with an end-to-end metric read
from the device's trace (its driver's `traced_metrics`) profiles that
block after the window with --trace 0 too. Every run checks the timed path's outputs
against the plain reference (sedbench/reference) and prints each number
compared beside its limit, last on standard error and last in the result
line. The last line of standard output is the result's JSON object.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()  # noqa: E402  (set-up counts from here)

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "desed_task_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def cell_files(name: str, bench: dict, here: Path = HERE) -> dict:
    """The cell's manifest entry, configuration, traffic mix and limits."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {sorted(cells)}")
    w = cells[name]
    return {"workload": w,
            "config": load_json(here / "configs" / f"{w['config']}.json"),
            "traffic": load_json(here / "traffic" / f"{w['traffic']}.json"),
            "cell": load_json(here / "workloads" / f"{name}.json")}


def metric_reader(name: str, here: Path = HERE):
    """metrics/<name>.py's `read(ctx) -> float | None`."""
    path = here / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"sedbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def driver(name: str, here: Path = HERE):
    """drivers/<name>.py, the module that runs one kind of traffic: its
    `Cell(config, traffic, seed, device, fault)`, `FAULTS` and `compare`."""
    if here == HERE:
        return importlib.import_module(f"sedbench.drivers.{name}")
    mod = f"sedbench.drivers._{abs(hash(str(here)))}_{name}"  # a copy of the harness
    if mod not in sys.modules:
        spec = importlib.util.spec_from_file_location(mod, here / "drivers" / f"{name}.py")
        sys.modules[mod] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(sys.modules[mod])
    return sys.modules[mod]


def make_cell(files: dict, seed: int, device, fault=None, here: Path = HERE):
    cls = driver(files["traffic"]["driver"], here).Cell
    return cls(files["config"], files["traffic"], seed, device, fault)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def power_limit_w() -> float | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"], capture_output=True,
                             text=True, timeout=20)
        return float(out.stdout.split()[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        return None


class Context:
    """What a per-layer metric reads: the untraced window's host clock
    (`window`), the traced block (`trace`, a trace.Trace, None off the
    card), the cell's configuration, mix and kind."""

    def __init__(self, cell, window: dict, trace, files: dict):
        self.kind = cell.kind
        self.window = window
        self.trace = trace
        self.config = files["config"]
        self.traffic = files["traffic"]


def cell_end_to_end(bench: dict, name: str) -> list[dict]:
    """The end-to-end metrics BENCHMARK.json gives the cell."""
    return [m for m in bench["end_to_end"] if "workloads" not in m or name in m["workloads"]]


def end_to_end(bench: dict, name: str, values: dict) -> dict:
    """The cell's end-to-end metrics, of the values its driver reports (a
    value it could not read, None, is left out: main refuses the run)."""
    return {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
            for m in cell_end_to_end(bench, name) if values.get(m["name"]) is not None}


def per_layer(bench: dict, name: str, ctx: Context, here: Path = HERE) -> dict:
    e2e = {m["name"] for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]}
    out = {}
    for m in bench["per_layer"]:
        if "workloads" in m and name not in m["workloads"]:
            continue
        if "workloads" not in m and m["moves"] not in e2e:
            continue
        v = metric_reader(m["name"], here)(ctx)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """Each number compared beside its limit; correct when every one is
    finite and within it."""
    import math

    checks, ok = {}, True
    for k, limit in limits.items():
        v = numbers[k]
        good = math.isfinite(v) and v <= limit
        ok &= good
        checks[k] = {"value": v, "limit": limit}
    return ok, checks


def run(workload: str, seed: int, seconds: float, trace: bool, device="cuda", fault=None,
        files: dict | None = None, bench: dict | None = None, here: Path = HERE) -> dict:
    """One run; returns the result object (the chip check is main's)."""
    import torch

    from .trace import traced

    bench = manifest() if bench is None else bench
    files = cell_files(workload, bench, here) if files is None else files
    cell = make_cell(files, seed, device, fault, here)
    cell.setup()
    setup_s = time.perf_counter() - T_PROCESS
    win = cell.window(seconds)
    tr = None
    e2e = {m["name"] for m in cell_end_to_end(bench, workload)}
    if trace or e2e & set(cell.traced_metrics):  # a device-trace end-to-end metric
        box = [cell.trace_units()]
        with traced(box) as got:
            for _ in range(box[0]):
                cell.run_unit()
        tr = got[0]
    cell.free()
    numbers = cell.check()
    ok, checks = judge(numbers, files["cell"]["limits"])
    found = forbidden_modules()
    dev = {"platform": "gpu" if torch.device(device).type == "cuda" else "cpu",
           "kind": torch.cuda.get_device_name() if torch.cuda.is_available() else "cpu",
           "count": files["workload"]["chips"], "memory_peak_bytes": win["peak_bytes"]}
    result = {"correct": ok and win["failed"] == 0, "attempted": win["units"],
              "failed": win["failed"]}
    if trace:
        ctx = Context(cell, win, tr, files)
        result["metrics"] = per_layer(bench, workload, ctx, here)
        dev.update(busy_s=tr.busy_s(), window_s=tr.window_s)
        result["breakdown"] = {"device_ops": tr.top_ops(), "idle_gaps": tr.idle_by_span()}
    else:
        result["metrics"] = end_to_end(bench, workload, cell.end_to_end(win, setup_s, tr))
    dev["power_limit_w"] = power_limit_w()
    result["device"] = dev
    result["checks"] = checks
    result["_forbidden"] = found
    result["_numbers"] = numbers
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = manifest()
    files = cell_files(args.workload, bench)
    import torch

    chips = files["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"sedbench: the cell needs {chips} CUDA device(s), found {n}", file=sys.stderr)
        return 2
    result = run(args.workload, args.seed, args.seconds, bool(args.trace), "cuda",
                 files=files, bench=bench)
    found = result.pop("_forbidden")
    numbers = result.pop("_numbers")
    if found:
        print(f"sedbench: modules of JAX or the JAX package were loaded: {found}",
              file=sys.stderr)
        return 3
    missing = [m["name"] for m in cell_end_to_end(bench, args.workload)
               if not args.trace and m["name"] not in result["metrics"]]
    if missing:
        print(f"sedbench: end-to-end metrics not read: {missing}", file=sys.stderr)
        return 4
    where = {k: v for k, v in numbers.get("_where", {}).items() if k != "grad_leaves"}
    if where:
        print(f"sedbench: where the gaps are: {json.dumps(where)}", file=sys.stderr)
    for k, c in result["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
