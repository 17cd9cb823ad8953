"""Score-curve segment metrics: AUROC / partial AUROC / best F-score (own
copy of desed_task_tpu/metrics/segments.py).

Replacements for the sed_scores_eval.segment_based functions the 2024 recipe
uses for MAESTRO evaluation (sed_trainer_pretrained.py:699-739):
auroc(..., segment_length=1.0[, max_fpr=0.1]) and best_fscore(...).

Inputs follow the sed_scores_eval convention:
  scores:        {clip_id: score table (onset, offset, <class>... columns:
                 piecewise-constant frame scores over [onset, offset) rows)
                 or decode.ScoreCurve}
  ground_truth:  {clip_id: [(onset, offset, label), ...]}
  durations:     {clip_id: seconds}

Per 1-s segment the class score is the max of the score curve within the
segment; a segment is positive when a gt event of that class overlaps it.
AUROC uses trapezoidal integration over the tie-grouped ROC; partial AUROC
applies sklearn-style McClish standardization by default (validated against
sklearn.roc_auc_score(max_fpr=...) in tests).
"""

from __future__ import annotations

import math
from collections import defaultdict

import numpy as np

from ..inference.decode import ScoreCurve, as_score_curve
from ..utils import table as tbl


def segment_scores_and_labels(
    scores: dict,
    ground_truth: dict,
    durations: dict,
    segment_length: float = 1.0,
    event_classes: list[str] | None = None,
):
    """Flatten all clips into per-class (scores, labels) over fixed segments.

    Scores may be score tables or decode's ScoreCurve tuples.
    Per segment the class score is max over the overlapping score rows
    (searchsorted range, vectorized over classes); a segment is positive
    when a gt event of that class strictly overlaps it."""
    if event_classes is None:
        first = next(iter(scores.values()))
        if isinstance(first, ScoreCurve):
            raise ValueError("event_classes is required with array score inputs")
        event_classes = list(as_score_curve(first).classes)
    C = len(event_classes)
    cindex = {c: i for i, c in enumerate(event_classes)}
    score_chunks, label_chunks = [], []
    for clip_id, curve in scores.items():
        dur = durations[clip_id]
        n_seg = max(1, int(math.ceil(dur / segment_length)))
        if isinstance(curve, ScoreCurve):
            vals = curve.select(event_classes)  # [n_rows, C]
            onset, offset = curve.timestamps[:-1], curve.timestamps[1:]
        else:
            onset, offset = tbl.column(curve, "onset"), tbl.column(curve, "offset")
            vals = np.stack([tbl.column(curve, c) for c in event_classes], axis=1)
        seg_on = np.arange(n_seg) * segment_length
        seg_off = seg_on + segment_length
        # rows overlapping segment s: offset > seg_on[s] and onset < seg_off[s]
        first_row = np.searchsorted(offset, seg_on, side="right")
        last_row = np.searchsorted(onset, seg_off, side="left")
        seg_vals = np.zeros((n_seg, C))
        for s in range(n_seg):
            if last_row[s] > first_row[s]:
                seg_vals[s] = vals[first_row[s]:last_row[s]].max(0)
        seg_lab = np.zeros((n_seg, C), bool)
        for on, off, lab in ground_truth.get(clip_id, ()):
            ci = cindex.get(lab)
            if ci is None:
                continue
            if off > on:
                s0 = int(math.floor(on / segment_length))
                s1 = int(math.ceil(off / segment_length))
            else:  # zero-length event: active iff it falls inside a segment
                s0 = int(math.floor(on / segment_length))
                s1 = s0 + 1 if on / segment_length != s0 else s0
            seg_lab[max(s0, 0):min(s1, n_seg), ci] = True
        score_chunks.append(seg_vals)
        label_chunks.append(seg_lab)
    all_scores = (
        np.concatenate(score_chunks) if score_chunks else np.zeros((0, C))
    )
    all_labels = (
        np.concatenate(label_chunks) if label_chunks else np.zeros((0, C), bool)
    )
    return (
        {c: all_scores[:, i] for i, c in enumerate(event_classes)},
        {c: all_labels[:, i] for i, c in enumerate(event_classes)},
        event_classes,
    )


def _roc(scores: np.ndarray, labels: np.ndarray):
    """Tie-grouped ROC: returns (fpr, tpr) starting at (0, 0)."""
    order = np.argsort(-scores, kind="stable")
    s = scores[order]
    y = labels[order].astype(np.float64)
    distinct = np.r_[np.nonzero(np.diff(s))[0], len(s) - 1]
    tps = np.cumsum(y)[distinct]
    fps = (distinct + 1) - tps
    P = y.sum()
    N = len(y) - P
    tpr = tps / P if P > 0 else np.zeros_like(tps)
    fpr = fps / N if N > 0 else np.zeros_like(fps)
    return np.r_[0.0, fpr], np.r_[0.0, tpr]


def _auc(fpr, tpr, max_fpr=None, mcclish=True):
    if max_fpr is None:
        return float(np.trapezoid(tpr, fpr))
    stop = np.searchsorted(fpr, max_fpr, side="right")
    x = fpr[:stop]
    y = tpr[:stop]
    if stop < len(fpr) and (len(x) == 0 or x[-1] < max_fpr):
        # interpolate the ROC at max_fpr (sklearn semantics)
        x0, x1 = fpr[stop - 1], fpr[stop]
        y0, y1 = tpr[stop - 1], tpr[stop]
        yi = y0 + (y1 - y0) * (max_fpr - x0) / (x1 - x0) if x1 > x0 else y0
        x = np.r_[x, max_fpr]
        y = np.r_[y, yi]
    pauc = float(np.trapezoid(y, x))
    if not mcclish:
        return pauc / max_fpr
    # sklearn's McClish standardization to [0.5, 1]
    min_area = 0.5 * max_fpr**2
    max_area = max_fpr
    return 0.5 * (1 + (pauc - min_area) / (max_area - min_area))


def auroc(
    scores: dict,
    ground_truth: dict,
    durations: dict,
    segment_length: float = 1.0,
    max_fpr: float | None = None,
    event_classes: list[str] | None = None,
    mcclish_correction: bool = True,
    precomputed=None,
) -> tuple[dict, dict]:
    """Segment-based (partial) AUROC; returns ({class: auc, "mean": m}, aux).

    ``precomputed`` takes the output of segment_scores_and_labels so callers
    evaluating several metrics on one score set flatten the segments once."""
    seg_scores, seg_labels, classes = precomputed or segment_scores_and_labels(
        scores, ground_truth, durations, segment_length, event_classes
    )
    out = {}
    for c in classes:
        fpr, tpr = _roc(seg_scores[c], seg_labels[c])
        out[c] = _auc(fpr, tpr, max_fpr, mcclish_correction)
    out["mean"] = float(np.mean([out[c] for c in classes])) if classes else 0.0
    return out, {"classes": classes}


def best_fscore(
    scores: dict,
    ground_truth: dict,
    durations: dict,
    segment_length: float = 1.0,
    event_classes: list[str] | None = None,
    beta: float = 1.0,
    precomputed=None,
) -> tuple[dict, dict]:
    """Per-class best-threshold segment F-score; macro = mean of per-class
    optima (the 'fmo' objective of the 2024 recipe)."""
    seg_scores, seg_labels, classes = precomputed or segment_scores_and_labels(
        scores, ground_truth, durations, segment_length, event_classes
    )
    f_out = {}
    thresholds = {}
    for c in classes:
        s = seg_scores[c]
        y = seg_labels[c]
        order = np.argsort(-s, kind="stable")
        ss, yy = s[order], y[order].astype(np.float64)
        distinct = np.r_[np.nonzero(np.diff(ss))[0], len(ss) - 1]
        tp = np.cumsum(yy)[distinct]
        fp = (distinct + 1) - tp
        fn = yy.sum() - tp
        denom = (1 + beta**2) * tp + beta**2 * fn + fp
        with np.errstate(divide="ignore", invalid="ignore"):
            f = np.where(denom > 0, (1 + beta**2) * tp / denom, 0.0)
        best = int(np.argmax(f)) if len(f) else 0
        f_out[c] = float(f[best]) if len(f) else 0.0
        thresholds[c] = float(ss[distinct[best]]) if len(f) else 0.5
    f_out["macro_average"] = float(np.mean([f_out[c] for c in classes])) if classes else 0.0
    return f_out, {"thresholds": thresholds}


def fscore(
    scores: dict,
    ground_truth: dict,
    durations: dict,
    threshold: float = 0.5,
    segment_length: float = 1.0,
    event_classes: list[str] | None = None,
    beta: float = 1.0,
    precomputed=None,
) -> tuple[dict, dict]:
    """Fixed-threshold segment F-score (sed_scores_eval.segment_based.fscore
    analog; the best_fscore sibling optimizes the threshold per class)."""
    seg_scores, seg_labels, classes = precomputed or segment_scores_and_labels(
        scores, ground_truth, durations, segment_length, event_classes
    )
    out = {}
    for c in classes:
        pred = seg_scores[c] > threshold
        y = seg_labels[c]
        tp = float((pred & y).sum())
        fp = float((pred & ~y).sum())
        fn = float((~pred & y).sum())
        denom = (1 + beta**2) * tp + beta**2 * fn + fp
        out[c] = (1 + beta**2) * tp / denom if denom > 0 else 0.0
    out["macro_average"] = (
        float(np.mean([out[c] for c in classes])) if classes else 0.0
    )
    return out, {"threshold": threshold}

