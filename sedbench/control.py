"""Readings that set a cell's correctness limits, on the chip at the cell's
own size; the benchmark's own runs never run this.

    python3 -m sedbench.control --workload <cell> --seeds 1,2,3 [--faults [name,...]]

For each seed, in one process: the program's timed path (set-up's checked
steps, or one window of passes) against the fp32 reference ("program"),
and the control, the reference put in the program's place and computed one
precision below the configuration's bfloat16 (float8 e4m3 under a
per-tensor scale, `reference.model.fp8`), against the same reference
("control"). With --faults, each fault of the cell's kind planted in the
timed path (drivers' FAULTS), or those named, against the same reference. One JSON line a
reading; the numbers are those `run.py` compares.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from . import run
from .reference.model import exact, fp8


def readings(files: dict, seed: int, device, faults, seconds: float = 1.0):
    """Yield (what, numbers) for one seed; `faults` True (all of the
    kind's), False or a list of names."""
    drv = run.driver(files["traffic"]["driver"])
    cell = run.make_cell(files, seed, device)
    cell.setup()
    if cell.kind == "eval":
        cell.window(seconds)
    got = cell.program_result()
    cell.free()
    ref = cell.reference_result(exact)
    yield "program", drv.compare(got, ref)
    yield "control", drv.compare(cell.reference_result(fp8), ref)
    if faults:
        for fault in drv.FAULTS if faults is True else faults:
            bad = run.make_cell(files, seed, device, fault)
            bad.setup()
            if bad.kind == "eval":
                bad.window(seconds)
            res = bad.program_result()
            bad.free()
            yield fault, drv.compare(res, ref)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--faults", nargs="?", const="all", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("sedbench.control: no CUDA device", file=sys.stderr)
        return 2
    files = run.cell_files(args.workload, run.manifest())
    for seed in (int(s) for s in args.seeds.split(",")):
        faults = args.faults == "all" or (args.faults.split(",") if args.faults else False)
        for what, numbers in readings(files, seed, "cuda", faults):
            where = numbers.pop("_where", {})
            if "grad_leaves" in where:
                numbers["grad_leaves"] = where["grad_leaves"]
            print(json.dumps({"workload": args.workload, "seed": seed, "what": what, **numbers}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
