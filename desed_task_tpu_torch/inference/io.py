"""Score and prediction files (own copy of desed_task_tpu/inference/io.py,
with the csv module in place of pandas; the files have the same layout:
tab-separated, a header row, no index column).
"""

from __future__ import annotations

import csv
from pathlib import Path

import numpy as np

from ..utils import table as tbl
from .decode import ScoreCurve


def _write_tsv(path: Path, names: list[str], cols: list) -> None:
    with open(path, "w", newline="") as f:
        w = csv.writer(f, delimiter="\t", lineterminator="\n")
        w.writerow(names)
        w.writerows(zip(*cols))


def write_sed_scores(scores: dict, out_dir) -> int:
    """{clip_id: score table or ScoreCurve} -> one tsv per clip, columns
    onset, offset, then one per class."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    for clip_id, curve in scores.items():
        if isinstance(curve, ScoreCurve):
            ts, vals = curve.timestamps, curve.values
            names = ["onset", "offset", *curve.classes]
            cols = [ts[:-1], ts[1:], *vals.T]
        else:
            names = tbl.columns(curve)
            cols = [tbl.column(curve, c) for c in names]
        _write_tsv(out_dir / f"{clip_id}.tsv", names, cols)
    return len(scores)


def read_sed_scores(in_dir) -> dict:
    """{clip_id: score table (dict of float64 columns)} from write_sed_scores'
    files."""
    out = {}
    for p in sorted(Path(in_dir).glob("*.tsv")):
        with open(p, newline="") as f:
            rows = list(csv.reader(f, delimiter="\t"))
        names, data = rows[0], np.asarray(rows[1:], dtype=np.float64).reshape(-1, len(rows[0]))
        out[p.stem] = {c: data[:, i] for i, c in enumerate(names)}
    return out


def write_predictions(prediction_dfs: dict, out_dir, prefix: str = "predictions_th") -> list:
    """{threshold: event table} -> predictions_th_<th>.tsv files (the
    operating-point layout of PSDS_Eval/meta/metrics_test)."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    written = []
    for th, table in prediction_dfs.items():
        path = out_dir / f"{prefix}_{th:.2f}.tsv"
        names = tbl.columns(table)
        _write_tsv(path, names, [tbl.column(table, c) for c in names])
        written.append(path)
    return written


def read_ground_truth_events(tsv) -> dict:
    """Event table (filename, onset, offset, event_label) ->
    {clip_stem: [(onset, offset, label), ...]} (sed_scores_eval.io layout);
    a file whose rows have no label maps to []."""
    out: dict = {}
    for fname, on, off, lab in zip(tsv["filename"], tsv["onset"], tsv["offset"],
                                   tsv["event_label"]):
        stem = str(Path(fname).stem)
        if not tbl.is_missing(lab):
            out.setdefault(stem, []).append((float(on), float(off), str(lab)))
        else:
            out.setdefault(stem, [])
    return out
