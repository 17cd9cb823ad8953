"""Score-based (threshold-free) PSDS and F-scores (own copy of
desed_task_tpu/metrics/scores.py, on event tables: utils/table.py).

API-parity replacements for the sed_scores_eval functions the reference calls
(evaluation_measures.py compute_psds_from_scores :258-303;
sed_trainer_pretrained.py:641-669 intersection/collar fscore at 0.5).

EXACT change-point evaluation (sed_scores_eval semantics, Ebbers et al.
ICASSP 2022): scores are piecewise-constant curves, so every counting
statistic (TP / FP / cross-trigger) is a step function of the decision
threshold whose change points are the distinct score values. Per clip and
class we enumerate ALL distinct superlevel sets `score > tau` (tau in
{-inf} ∪ unique scores — every possible detection set), count with the
fixture-validated DTC/GTC/CTTC rules (metrics/psds.py), and merge the
per-clip step functions into dataset-level TP(tau)/FP(tau)/CT(tau) by
delta-accumulation over the union of change points. The per-class PSD-ROC
support is therefore exact — no threshold grid, no approximation.

Scores: {clip_id: score table (onset, offset, <class>...) or ScoreCurve} —
the decode output.
"""

from __future__ import annotations

import numpy as np

from ..inference.decode import as_score_curve
from ..labels.events import find_contiguous_regions
from ..utils import table as tbl
from .event_based import event_based_metrics
from .psds import PSDSEval, compute_per_intersection_macro_f1, psds_from_points


def scores_to_event_df(scores: dict, threshold: float, event_classes: list[str] | None = None):
    """Threshold piecewise-constant score curves into an event table.

    Scores may be score tables or decode.ScoreCurve tuples."""
    rows = []
    for clip_id, df in scores.items():
        curve = as_score_curve(df)
        classes = list(event_classes or curve.classes)
        onset = curve.timestamps[:-1]
        offset = curve.timestamps[1:]
        vals = curve.select(classes)
        act = vals > threshold
        for ci, c in enumerate(classes):
            for a, b in find_contiguous_regions(act[:, ci]):
                rows.append((c, float(onset[a]), float(offset[b - 1]), f"{clip_id}.wav"))
    return tbl.event_table(rows)


def _segment_overlaps(t: np.ndarray, intervals: np.ndarray) -> np.ndarray:
    """Pairwise overlap durations of score segments [t[i], t[i+1}) with
    `intervals` [E, 2] -> [n_segments, E]."""
    lo = np.maximum(t[:-1, None], intervals[None, :, 0])
    hi = np.minimum(t[1:, None], intervals[None, :, 1])
    return np.maximum(0.0, hi - lo)


def _clip_class_step_counts(
    t: np.ndarray,
    s: np.ndarray,
    gt_c: np.ndarray | None,
    other_gts: list[tuple[int, np.ndarray]],
    n_classes: int,
    dtc: float,
    gtc: float,
    cttc: float | None,
):
    """Exact per-threshold TP/FP/CT counts for ONE clip and ONE class.

    The detection set {score > tau} is constant for tau in [u_j, u_{j+1})
    where u are the sorted unique scores, so enumerating tau in
    {-inf} ∪ unique(s) covers every possible detection set. Counting rules
    mirror PSDSEval.evaluate_detections (fixture-validated) exactly.

    Returns right-continuous step functions (taus[T], tp[T], fp[T], ct[T, C]):
    row j holds for any threshold in [taus[j], taus[j+1}).
    """
    d = np.diff(t)
    u = np.unique(s)
    taus = np.concatenate([[-np.inf], u])
    T, n = len(taus), len(s)
    act = s[None, :] > taus[:, None]  # [T, n]
    prev = np.zeros_like(act)
    prev[:, 1:] = act[:, :-1]
    starts = act & ~prev
    run_id = np.cumsum(starts, axis=1) - 1  # valid where act
    n_runs = starts.sum(1)
    K = int(n_runs.max())
    ct = np.zeros((T, n_classes))
    if K == 0:  # no detections at any threshold (all scores identical -inf?)
        return taus, np.zeros(T, int), np.zeros(T, int), ct

    rows = np.broadcast_to(np.arange(T)[:, None], act.shape)
    key = (rows * K + run_id)[act]
    dur_run = np.bincount(
        key, np.broadcast_to(d, act.shape)[act], minlength=T * K
    ).reshape(T, K)
    exists = np.arange(K)[None, :] < n_runs[:, None]

    if gt_c is not None and len(gt_c):
        seg_ov = _segment_overlaps(t, gt_c)  # [n, E]
        o = seg_ov.sum(1)
        ov_run = np.bincount(
            key, np.broadcast_to(o, act.shape)[act], minlength=T * K
        ).reshape(T, K)
        with np.errstate(divide="ignore", invalid="ignore"):
            ratio = np.where(dur_run > 0, ov_run / dur_run, 0.0)
        dtc_ok = exists & (ratio >= dtc)
        # segments belonging to a DTC-valid run
        valid_seg = act & dtc_ok[rows, np.maximum(run_id, 0)]
        cover = valid_seg.astype(float) @ seg_ov  # [T, E]
        glen = gt_c[:, 1] - gt_c[:, 0]
        with np.errstate(divide="ignore", invalid="ignore"):
            gratio = np.where(glen[None, :] > 0, cover / glen[None, :], 0.0)
        tp = (gratio >= gtc).sum(1)
    else:
        dtc_ok = np.zeros((T, K), bool)
        tp = np.zeros(T, int)

    failing = exists & ~dtc_ok
    fp = failing.sum(1)
    if cttc is not None and other_gts:
        for cidx, og in other_gts:
            oc = _segment_overlaps(t, og).sum(1)
            oc_run = np.bincount(
                key, np.broadcast_to(oc, act.shape)[act], minlength=T * K
            ).reshape(T, K)
            with np.errstate(divide="ignore", invalid="ignore"):
                cratio = np.where(dur_run > 0, oc_run / dur_run, 0.0)
            ct[:, cidx] = (failing & (cratio >= cttc)).sum(1)
    return taus, tp, fp, ct


def _merge_clip_steps(per_clip: list, n_classes: int):
    """Merge per-clip right-continuous step functions into dataset-level ones
    by delta accumulation over the union of change points.

    per_clip: list of (taus, tp, fp, ct) from _clip_class_step_counts.
    Returns (taus[Tg], tp[Tg], fp[Tg], ct[Tg, C]) for the whole dataset.
    """
    base_tp = sum(int(c[1][0]) for c in per_clip)
    base_fp = sum(int(c[2][0]) for c in per_clip)
    base_ct = np.sum([c[3][0] for c in per_clip], axis=0)
    taus_all, dtp, dfp, dct = [], [], [], []
    for taus, tp, fp, ct in per_clip:
        if len(taus) <= 1:
            continue
        taus_all.append(taus[1:])
        dtp.append(np.diff(tp))
        dfp.append(np.diff(fp))
        dct.append(np.diff(ct, axis=0))
    if not taus_all:
        return (
            np.array([-np.inf]),
            np.array([base_tp]),
            np.array([base_fp]),
            base_ct[None, :],
        )
    taus_all = np.concatenate(taus_all)
    order = np.argsort(taus_all, kind="stable")
    taus_sorted = taus_all[order]
    tp_cum = base_tp + np.cumsum(np.concatenate(dtp)[order])
    fp_cum = base_fp + np.cumsum(np.concatenate(dfp)[order])
    ct_cum = base_ct[None, :] + np.cumsum(np.concatenate(dct)[order], axis=0)
    # collapse equal change points: keep the LAST row at each tau (all deltas
    # at that threshold applied)
    keep = np.append(taus_sorted[1:] != taus_sorted[:-1], True)
    return (
        np.concatenate([[-np.inf], taus_sorted[keep]]),
        np.concatenate([[base_tp], tp_cum[keep]]),
        np.concatenate([[base_fp], fp_cum[keep]]),
        np.concatenate([base_ct[None, :], ct_cum[keep]], axis=0),
    )


def compute_psds_from_scores(
    scores: dict,
    ground_truth,
    audio_durations,
    dtc_threshold: float = 0.5,
    gtc_threshold: float = 0.5,
    cttc_threshold: float | None = None,
    alpha_ct: float = 0.0,
    alpha_st: float = 0.0,
    max_efpr: float = 100.0,
) -> float:
    """Threshold-free PSDS from piecewise-constant score curves — EXACT
    change-point enumeration (sed_scores_eval semantics,
    reference evaluation_measures.py:258-303)."""
    gt = _as_gt_df(ground_truth)
    dur = _as_dur_df(audio_durations)
    ev = PSDSEval(
        gt, dur,
        dtc_threshold=dtc_threshold,
        gtc_threshold=gtc_threshold,
        cttc_threshold=cttc_threshold,
    )
    curves = {k: as_score_curve(v) for k, v in scores.items()}
    C = len(ev.class_names)
    points = []
    for c, cname in enumerate(ev.class_names):
        per_clip = []
        for clip_id, curve in curves.items():
            if cname not in curve.classes:
                continue
            fname = f"{clip_id}.wav"
            t = curve.timestamps
            s = curve.values[:, curve.classes.index(cname)].astype(float)
            gt_c = ev._gt.get((fname, cname))
            others = [
                (ev._cindex[lab], ev._gt[(fname, lab)])
                for lab in ev._gt_by_file.get(fname, ())
                if lab != cname
            ] if cttc_threshold is not None else []
            per_clip.append(
                _clip_class_step_counts(
                    t, s, gt_c, others, C,
                    dtc_threshold, gtc_threshold, cttc_threshold,
                )
            )
        _, tp, fp, ct = _merge_clip_steps(per_clip, C)
        with np.errstate(divide="ignore", invalid="ignore"):
            tpr = np.where(ev.n_gt[c] > 0, tp / ev.n_gt[c], 0.0)
        efpr = fp * 3600.0 / ev.dataset_duration
        if alpha_ct > 0 and cttc_threshold is not None:
            with np.errstate(divide="ignore", invalid="ignore"):
                ctr = np.where(ev.t_gt[None, :] > 0, ct * 3600.0 / ev.t_gt[None, :], 0.0)
            ctr[:, c] = 0.0
            # psds_eval fixture-calibrated detail: row mean over ALL C classes
            efpr = efpr + alpha_ct * ctr.sum(1) / max(C, 1)
        points.append((efpr, tpr))
    return psds_from_points(points, alpha_st=alpha_st, max_efpr=max_efpr)


def intersection_fscore_from_scores(
    scores: dict,
    ground_truth,
    audio_durations,
    threshold: float = 0.5,
    dtc_threshold: float = 0.5,
    gtc_threshold: float = 0.5,
) -> float:
    """sed_scores_eval.intersection_based.fscore macro_average equivalent."""
    det = scores_to_event_df(scores, threshold)
    return compute_per_intersection_macro_f1(
        det, _as_gt_df(ground_truth), _as_dur_df(audio_durations),
        dtc_threshold=dtc_threshold, gtc_threshold=gtc_threshold,
    )


def collar_fscore_from_scores(
    scores: dict,
    ground_truth,
    threshold: float = 0.5,
    onset_collar: float = 0.2,
    offset_collar: float = 0.2,
    offset_collar_rate: float = 0.2,
) -> dict:
    """sed_scores_eval.collar_based.fscore equivalent (macro + per class)."""
    det = scores_to_event_df(scores, threshold)
    gt = _as_gt_df(ground_truth)
    classes = sorted(tbl.labels(gt))
    res = event_based_metrics(
        gt, det, classes,
        t_collar=max(onset_collar, offset_collar),
        percentage_of_length=offset_collar_rate,
    )
    return {"macro_average": res["macro_f_measure"], **{
        c: v["f_measure"] for c, v in res["class_wise"].items()
    }}


def _as_gt_df(gt):
    """An event table, or {clip_id: [(onset, offset, label)]} -> event table."""
    if "event_label" in tbl.columns(gt):
        return gt
    return tbl.event_table((lab, on, off, f"{clip_id}.wav")
                           for clip_id, events in gt.items() for on, off, lab in events)


def _as_dur_df(dur):
    """A duration table, or {clip_id: seconds} -> duration table."""
    if "duration" in tbl.columns(dur):
        return dur
    return {"filename": np.asarray([f"{k}.wav" for k in dur], dtype=object),
            "duration": np.asarray(list(dur.values()), dtype=np.float64)}
