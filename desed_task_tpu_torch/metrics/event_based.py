"""Collar-based (event) and fixed-grid (segment) F-measures (own copy of
desed_task_tpu/metrics/event_based.py).

The sed_eval metrics the reference wraps in
desed_task/evaluation/evaluation_measures.py (event_based_evaluation_df :50
with t_collar=0.2 / 20% length tolerance, segment_based_evaluation_df :96
with 1 s resolution), implemented from their definitions.

Event lists are event tables (utils/table.py: column mappings or
DataFrames) with columns filename/onset/offset/event_label (the tsv format
used throughout DCASE).
"""

from __future__ import annotations

import math
from collections import defaultdict

import numpy as np

from ..utils import table as tbl


def _per_file(table) -> dict[str, list[tuple[str, float, float]]]:
    out: dict[str, list] = defaultdict(list)
    for fname, on, off, lab in tbl.events(table):
        out[fname].append((lab, on, off))
    return out


def _fscore(tp, fp, fn):
    denom = 2 * tp + fp + fn
    return (2 * tp / denom) if denom > 0 else 0.0


def _precision(tp, n_sys):
    return tp / n_sys if n_sys else 0.0


def _recall(tp, n_ref):
    return tp / n_ref if n_ref else 0.0


def event_based_metrics(
    reference,
    estimated,
    classes: list[str] | None = None,
    t_collar: float = 0.200,
    percentage_of_length: float = 0.2,
    evaluate_onset: bool = True,
    evaluate_offset: bool = True,
) -> dict:
    """Collar-matched event F1 (macro + micro + per class).

    Match condition (same file, same class):
        onset:  |on_sys - on_ref| <= t_collar
        offset: |off_sys - off_ref| <= max(t_collar, percentage_of_length *
                (off_ref - on_ref))
    TPs form a maximum bipartite matching per (file, class).
    """
    if classes is None:
        classes = sorted(tbl.labels(reference) | tbl.labels(estimated))
    ref_files = _per_file(reference)
    est_files = _per_file(estimated)
    per_class = {c: {"tp": 0, "n_ref": 0, "n_sys": 0} for c in classes}

    for fname in set(ref_files) | set(est_files):
        refs = ref_files.get(fname, [])
        ests = est_files.get(fname, [])
        by_class_ref: dict[str, list] = defaultdict(list)
        by_class_est: dict[str, list] = defaultdict(list)
        for lab, on, off in refs:
            by_class_ref[lab].append((on, off))
        for lab, on, off in ests:
            by_class_est[lab].append((on, off))
        for c in set(by_class_ref) | set(by_class_est):
            if c not in per_class:
                continue
            r = by_class_ref.get(c, [])
            e = by_class_est.get(c, [])
            per_class[c]["n_ref"] += len(r)
            per_class[c]["n_sys"] += len(e)
            if not r or not e:
                continue
            # greedy first-fit in input order — exact sed_eval semantics
            # (PARITY #8: the one fixture-report delta is a float artifact of
            # the committed CSV's rounding, proven in test_metrics_golden)
            used = [False] * len(e)
            tp = 0
            for on_r, off_r in r:
                for j, (on_s, off_s) in enumerate(e):
                    if used[j]:
                        continue
                    ok = True
                    if evaluate_onset:
                        ok = ok and abs(on_s - on_r) <= t_collar
                    if evaluate_offset:
                        tol = max(t_collar, percentage_of_length * (off_r - on_r))
                        ok = ok and abs(off_s - off_r) <= tol
                    if ok:
                        used[j] = True
                        tp += 1
                        break
            per_class[c]["tp"] += tp

    return _summarize(per_class, classes)


def _segment_roll(events, n_segments, res, class_index):
    roll = np.zeros((n_segments, len(class_index)), bool)
    for lab, on, off in events:
        if lab not in class_index:
            continue
        a = int(math.floor(on / res))
        b = int(math.ceil(off / res))
        roll[max(a, 0) : min(b, n_segments), class_index[lab]] = True
    return roll


def segment_based_metrics(
    reference,
    estimated,
    classes: list[str] | None = None,
    time_resolution: float = 1.0,
    file_durations=None,
) -> dict:
    """Fixed-grid segment F1 (macro + micro + per class).

    Each file is cut into `time_resolution` segments covering
    [0, max event offset] (or the provided file duration); a (segment, class)
    is active if any event of that class overlaps the segment.
    """
    if classes is None:
        classes = sorted(tbl.labels(reference) | tbl.labels(estimated))
    cindex = {c: i for i, c in enumerate(classes)}
    ref_files = _per_file(reference)
    est_files = _per_file(estimated)
    durations = None
    if file_durations is not None:
        durations = dict(zip(file_durations["filename"], file_durations["duration"]))
    per_class = {c: {"tp": 0, "n_ref": 0, "n_sys": 0} for c in classes}

    for fname in set(ref_files) | set(est_files):
        refs = ref_files.get(fname, [])
        ests = est_files.get(fname, [])
        if durations is not None and fname in durations:
            end = durations[fname]
        else:
            end = max([off for _, _, off in refs + ests], default=0.0)
        n_seg = int(math.ceil(end / time_resolution))
        if n_seg == 0:
            continue
        ref_roll = _segment_roll(refs, n_seg, time_resolution, cindex)
        est_roll = _segment_roll(ests, n_seg, time_resolution, cindex)
        tp = ref_roll & est_roll
        for c, i in cindex.items():
            per_class[c]["tp"] += int(tp[:, i].sum())
            per_class[c]["n_ref"] += int(ref_roll[:, i].sum())
            per_class[c]["n_sys"] += int(est_roll[:, i].sum())

    return _summarize(per_class, classes)


def _summarize(per_class: dict, classes: list[str]) -> dict:
    tot_tp = sum(v["tp"] for v in per_class.values())
    tot_ref = sum(v["n_ref"] for v in per_class.values())
    tot_sys = sum(v["n_sys"] for v in per_class.values())
    class_wise = {}
    for c in classes:
        v = per_class[c]
        fp = v["n_sys"] - v["tp"]
        fn = v["n_ref"] - v["tp"]
        class_wise[c] = {
            "f_measure": _fscore(v["tp"], fp, fn),
            "precision": _precision(v["tp"], v["n_sys"]),
            "recall": _recall(v["tp"], v["n_ref"]),
            "n_ref": v["n_ref"],
            "n_sys": v["n_sys"],
            "tp": v["tp"],
        }
    macro = float(np.mean([class_wise[c]["f_measure"] for c in classes])) if classes else 0.0
    return {
        "class_wise": class_wise,
        "macro_f_measure": macro,
        "micro_f_measure": _fscore(tot_tp, tot_sys - tot_tp, tot_ref - tot_tp),
        "micro_precision": _precision(tot_tp, tot_sys),
        "micro_recall": _recall(tot_tp, tot_ref),
    }
