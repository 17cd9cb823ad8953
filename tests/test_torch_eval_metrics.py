"""The port's DCASE metrics (desed_task_tpu_torch/metrics) against the JAX
package's on the same seeded ground truth and detections.

Both sides compute in float64 numpy, so counts must be equal and rates,
PSDS and AUCs within 1e-12. Each side gets the same pandas DataFrames; the
port also gets its own column tables (dicts of numpy arrays) of the same
rows, and must give the same numbers from them."""

import math

import numpy as np
import pandas as pd
import pytest

from desed_task_tpu.inference import decode as jdecode
from desed_task_tpu.labels.encoder import ManyHotEncoder as JEncoder
from desed_task_tpu.metrics import event_based as jeb
from desed_task_tpu.metrics import matching as jmatch
from desed_task_tpu.metrics import psds as jpsds
from desed_task_tpu.metrics import scores as jscores
from desed_task_tpu.metrics import segments as jseg
from desed_task_tpu_torch.inference import decode as tdecode
from desed_task_tpu_torch.metrics import event_based as teb
from desed_task_tpu_torch.metrics import matching as tmatch
from desed_task_tpu_torch.metrics import psds as tpsds
from desed_task_tpu_torch.metrics import scores as tscores
from desed_task_tpu_torch.metrics import segments as tseg

TOL = 1e-12
CLASSES = ["Alarm_bell_ringing", "Blender", "Cat", "Dishes", "Dog", "Speech"]
N_FILES, T = 12, 156
THRESHOLDS = (0.1, 0.3, 0.5, 0.7, 0.9)
ENC = dict(labels=CLASSES, audio_len=10, frame_len=2048, frame_hop=256, net_pooling=4,
           fs=16000)


def _as_table(df) -> dict:
    """The port's form of a DataFrame: a dict of numpy columns."""
    return {c: df[c].to_numpy() for c in df.columns}


def _ground_truth(seed):
    """Seeded DESED-style ground truth: 0-4 events a file (the last file has
    none, as a row with a missing label), durations 10 s."""
    r = np.random.default_rng(seed)
    rows = []
    for i in range(N_FILES - 1):
        for _ in range(r.integers(0, 5)):
            on = round(float(r.uniform(0, 9)), 3)
            off = round(min(10.0, on + float(r.uniform(0.1, 4))), 3)
            rows.append((f"clip_{i}.wav", on, off, CLASSES[r.integers(len(CLASSES))]))
    rows.append((f"clip_{N_FILES - 1}.wav", np.nan, np.nan, np.nan))
    gt = pd.DataFrame(rows, columns=["filename", "onset", "offset", "event_label"])
    dur = pd.DataFrame({"filename": [f"clip_{i}.wav" for i in range(N_FILES)],
                        "duration": [10.0] * N_FILES})
    return gt, dur


def _scores(seed, gt):
    """[N_FILES, C, T] scores: smoothed noise, raised where gt events are."""
    r = np.random.default_rng(seed)
    s = r.random((N_FILES, len(CLASSES), T))
    k = np.ones(9) / 9
    s = np.apply_along_axis(lambda v: np.convolve(v, k, mode="same"), -1, s)
    enc = JEncoder(**ENC)
    for f, on, off, lab in zip(gt["filename"], gt["onset"], gt["offset"], gt["event_label"]):
        if lab == lab:
            i = int(f.split("_")[1].split(".")[0])
            a, b = int(enc._time_to_frame(on)), int(math.ceil(enc._time_to_frame(off)))
            s[i, CLASSES.index(lab), a:b] += r.uniform(0.1, 0.5)
    return np.clip(s, 0, 1).astype(np.float32)


@pytest.fixture(scope="module", params=[0, 1])
def case(request):
    seed = request.param
    gt, dur = _ground_truth(seed)
    scores = _scores(seed + 10, gt)
    names = [f"clip_{i}.wav" for i in range(N_FILES)]
    raw, _, dets = jdecode.batched_decode_preds(scores, names, JEncoder(**ENC),
                                                thresholds=THRESHOLDS, median_filter=[3] * 6)
    curves = {k: tdecode.as_score_curve(v) for k, v in raw.items()}
    return dict(gt=gt, dur=dur, dets=dets, raw=raw, curves=curves)


def _close(a, b):
    """Equal structure; numbers within TOL, counts and strings equal."""
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _close(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _close(x, y)
    elif isinstance(a, np.ndarray) and a.dtype.kind in "fiub":
        assert a.shape == np.shape(b)
        np.testing.assert_allclose(a, b, rtol=0, atol=TOL)
    elif isinstance(a, (float, np.floating)):
        assert abs(float(a) - float(b)) <= TOL, (a, b)
    else:
        assert a == b, (a, b)


def test_bipartite_matching_matches_jax():
    r = np.random.default_rng(3)
    for _ in range(20):
        n_left, n_right = r.integers(1, 8, size=2)
        adj = {u: sorted(r.choice(n_right, r.integers(0, n_right + 1), replace=False).tolist())
               for u in range(n_left)}
        assert tmatch.max_bipartite_match(adj, n_right) == jmatch.max_bipartite_match(adj, n_right)
        assert tmatch.matching_size(adj, n_right) == jmatch.matching_size(adj, n_right)


@pytest.mark.parametrize("th", THRESHOLDS)
@pytest.mark.parametrize("flags", [(True, True), (True, False), (False, True)])
def test_event_based_metrics_match_jax(case, th, flags):
    gt, det = case["gt"], case["dets"][th]
    kw = dict(evaluate_onset=flags[0], evaluate_offset=flags[1])
    want = jeb.event_based_metrics(gt, det, CLASSES, **kw)
    _close(teb.event_based_metrics(gt, det, CLASSES, **kw), want)
    _close(teb.event_based_metrics(_as_table(gt), _as_table(det), CLASSES, **kw), want)
    # classes from the tables themselves
    _close(teb.event_based_metrics(_as_table(gt), _as_table(det)),
           jeb.event_based_metrics(gt, det))


@pytest.mark.parametrize("th", THRESHOLDS)
@pytest.mark.parametrize("with_durations", [False, True])
def test_segment_based_metrics_match_jax(case, th, with_durations):
    gt, det, dur = case["gt"], case["dets"][th], case["dur"]
    fd = dur if with_durations else None
    want = jeb.segment_based_metrics(gt, det, CLASSES, file_durations=fd)
    _close(teb.segment_based_metrics(gt, det, CLASSES, file_durations=fd), want)
    _close(teb.segment_based_metrics(_as_table(gt), _as_table(det), CLASSES,
                                     file_durations=None if fd is None else _as_table(fd)),
           want)


@pytest.mark.parametrize("scenario", [
    dict(dtc_threshold=0.7, gtc_threshold=0.7, alpha_ct=0, alpha_st=1),
    dict(dtc_threshold=0.1, gtc_threshold=0.1, cttc_threshold=0.3, alpha_ct=0.5, alpha_st=1),
    dict(dtc_threshold=0.5, gtc_threshold=0.5, cttc_threshold=0.3, alpha_ct=1.0, alpha_st=0,
         max_efpr=50.0),
])
def test_psds_from_operating_points_matches_jax(case, scenario):
    gt, dur = case["gt"], case["dur"]
    ops = [case["dets"][th] for th in THRESHOLDS]
    want, jev = jpsds.compute_psds_from_operating_points(ops, gt, dur, **scenario)
    got, tev = tpsds.compute_psds_from_operating_points(ops, gt, dur, **scenario)
    got_t, _ = tpsds.compute_psds_from_operating_points(
        [_as_table(o) for o in ops], _as_table(gt), _as_table(dur), **scenario)
    assert 0 <= want <= 1
    _close(got, want)
    _close(got_t, want)
    # the same from a dict keyed by threshold
    _close(tpsds.compute_psds_from_operating_points(dict(case["dets"]), gt, dur, **scenario)[0],
           want)
    assert tev.class_names == jev.class_names
    _close(tev.n_gt, jev.n_gt)
    _close(tev.t_gt, jev.t_gt)
    assert tev.dataset_duration == jev.dataset_duration
    alpha_ct = scenario.get("alpha_ct", 0.0)
    for th in THRESHOLDS:
        _close(tev.evaluate_detections(case["dets"][th]), jev.evaluate_detections(case["dets"][th]))
        _close(tev.operating_point(_as_table(case["dets"][th]), alpha_ct),
               jev.operating_point(case["dets"][th], alpha_ct))
    _close(tev.psd_roc(ops, alpha_ct), jev.psd_roc(ops, alpha_ct))


def test_psd_roc_from_points_matches_jax():
    r = np.random.default_rng(5)
    points = [(np.sort(r.uniform(0, 200, 7)), r.uniform(0, 1, 7)) for _ in range(4)]
    _close(tpsds.psd_roc_from_points(points), jpsds.psd_roc_from_points(points))
    for alpha_st, max_efpr in ((0.0, 100.0), (1.0, 100.0), (0.5, 30.0)):
        _close(tpsds.psds_from_points(points, alpha_st, max_efpr),
               jpsds.psds_from_points(points, alpha_st, max_efpr))


@pytest.mark.parametrize("th", THRESHOLDS)
@pytest.mark.parametrize("dtc_gtc", [(0.5, 0.5), (0.7, 0.7), (0.1, 0.1)])
def test_intersection_macro_f1_matches_jax(case, th, dtc_gtc):
    gt, dur, det = case["gt"], case["dur"], case["dets"][th]
    kw = dict(dtc_threshold=dtc_gtc[0], gtc_threshold=dtc_gtc[1])
    want = jpsds.compute_per_intersection_macro_f1(det, gt, dur, **kw)
    _close(tpsds.compute_per_intersection_macro_f1(det, gt, dur, **kw), want)
    _close(tpsds.compute_per_intersection_macro_f1(_as_table(det), _as_table(gt),
                                                   _as_table(dur), **kw), want)
    # {clip: table} dicts are concatenated first, as the JAX function does
    half = {"a": det.iloc[: len(det) // 2], "b": det.iloc[len(det) // 2:]}
    _close(tpsds.compute_per_intersection_macro_f1(
        {k: _as_table(v) for k, v in half.items()}, gt, dur, **kw),
        jpsds.compute_per_intersection_macro_f1(half, gt, dur, **kw))


def _segment_inputs(case):
    gt_tuples = {}
    for f, on, off, lab in zip(case["gt"]["filename"], case["gt"]["onset"],
                               case["gt"]["offset"], case["gt"]["event_label"]):
        stem = f[:-4]
        gt_tuples.setdefault(stem, [])
        if lab == lab:
            gt_tuples[stem].append((on, off, lab))
    durations = {k: 10.0 for k in case["raw"]}
    return gt_tuples, durations


@pytest.mark.parametrize("form", ["dataframe", "curve"])
def test_segment_metrics_match_jax(case, form):
    gt, dur = _segment_inputs(case)
    scores = case["raw"] if form == "dataframe" else case["curves"]
    jscores_in = case["raw"] if form == "dataframe" else {
        k: jdecode.ScoreCurve(*v) for k, v in case["curves"].items()}
    classes = None if form == "dataframe" else CLASSES
    pre_t = tseg.segment_scores_and_labels(scores, gt, dur, 1.0, classes)
    pre_j = jseg.segment_scores_and_labels(jscores_in, gt, dur, 1.0, classes)
    _close(pre_t, pre_j)
    for max_fpr, mcclish in ((None, True), (0.1, True), (0.1, False), (0.3, True)):
        _close(tseg.auroc(scores, gt, dur, 1.0, max_fpr, classes, mcclish)[0],
               jseg.auroc(jscores_in, gt, dur, 1.0, max_fpr, classes, mcclish)[0])
    _close(tseg.best_fscore(scores, gt, dur, 1.0, classes),
           jseg.best_fscore(jscores_in, gt, dur, 1.0, classes))
    for th in THRESHOLDS:
        _close(tseg.fscore(scores, gt, dur, th, 1.0, classes),
               jseg.fscore(jscores_in, gt, dur, th, 1.0, classes))
    # a 0.5 s grid
    _close(tseg.segment_scores_and_labels(scores, gt, dur, 0.5, classes),
           jseg.segment_scores_and_labels(jscores_in, gt, dur, 0.5, classes))


@pytest.mark.parametrize("scenario", [
    dict(dtc_threshold=0.7, gtc_threshold=0.7, alpha_ct=0, alpha_st=1),
    dict(dtc_threshold=0.1, gtc_threshold=0.1, cttc_threshold=0.3, alpha_ct=0.5, alpha_st=1),
])
@pytest.mark.parametrize("form", ["dataframe", "curve"])
def test_psds_from_scores_matches_jax(case, scenario, form):
    gt, dur = case["gt"], case["dur"]
    scores = case["raw"] if form == "dataframe" else case["curves"]
    want = jscores.compute_psds_from_scores(case["raw"], gt, dur, **scenario)
    assert 0 <= want <= 1
    _close(tscores.compute_psds_from_scores(scores, gt, dur, **scenario), want)
    _close(tscores.compute_psds_from_scores(scores, _as_table(gt), _as_table(dur), **scenario),
           want)
    # ground truth and durations as {clip_id: ...} dicts
    gt_d, dur_d = _segment_inputs(case)
    _close(tscores.compute_psds_from_scores(scores, gt_d, dur_d, **scenario),
           jscores.compute_psds_from_scores(case["raw"], gt_d, dur_d, **scenario))


@pytest.mark.parametrize("th", [0.3, 0.5, 0.7])
def test_fscores_from_scores_match_jax(case, th):
    gt, dur = case["gt"], case["dur"]
    want_i = jscores.intersection_fscore_from_scores(case["raw"], gt, dur, threshold=th)
    want_c = jscores.collar_fscore_from_scores(case["raw"], gt, threshold=th)
    for scores in (case["raw"], case["curves"]):
        _close(tscores.intersection_fscore_from_scores(scores, gt, dur, threshold=th), want_i)
        _close(tscores.collar_fscore_from_scores(scores, _as_table(gt), threshold=th), want_c)
    j_ev = jscores.scores_to_event_df(case["raw"], th)
    t_ev = tscores.scores_to_event_df(case["curves"], th)
    for c in j_ev.columns:
        assert list(t_ev[c]) == list(j_ev[c])


def test_perfect_and_empty_predictions_match_jax(case):
    """The edge cases of tests/test_metrics_golden.py: the ground truth as
    predictions saturates every metric; no detections at all."""
    gt, dur = case["gt"], case["dur"]
    preds = gt.copy()
    empty = pd.DataFrame(columns=["event_label", "onset", "offset", "filename"])
    for det in (preds, empty):
        for t_det in (det, _as_table(det)):
            _close(teb.event_based_metrics(gt, t_det, CLASSES),
                   jeb.event_based_metrics(gt, det, CLASSES))
            _close(teb.segment_based_metrics(gt, t_det, CLASSES),
                   jeb.segment_based_metrics(gt, det, CLASSES))
            _close(tpsds.compute_per_intersection_macro_f1(t_det, gt, dur),
                   jpsds.compute_per_intersection_macro_f1(det, gt, dur))
            for kw in (dict(dtc_threshold=0.7, gtc_threshold=0.7, alpha_ct=0, alpha_st=1),
                       dict(dtc_threshold=0.1, gtc_threshold=0.1, cttc_threshold=0.3,
                            alpha_ct=0.5, alpha_st=1)):
                _close(tpsds.compute_psds_from_operating_points([t_det], gt, dur, **kw)[0],
                       jpsds.compute_psds_from_operating_points([det], gt, dur, **kw)[0])
    classes = sorted(set(gt["event_label"].dropna()))
    assert teb.event_based_metrics(gt, preds, classes)["macro_f_measure"] == pytest.approx(1.0)
    assert tpsds.compute_per_intersection_macro_f1(preds, gt, dur) == pytest.approx(1.0)
    val, _ = tpsds.compute_psds_from_operating_points(
        [_as_table(preds)], gt, dur, dtc_threshold=0.7, gtc_threshold=0.7, alpha_ct=0, alpha_st=1)
    assert val == pytest.approx(1.0, abs=1e-6)
    assert teb.event_based_metrics(gt, empty, CLASSES)["micro_f_measure"] == 0.0
    # no detections at any threshold: every score 0
    zero = {k: tdecode.ScoreCurve(v.timestamps, np.zeros_like(v.values), v.classes)
            for k, v in case["curves"].items()}
    zero_j = {k: jdecode.ScoreCurve(*v) for k, v in zero.items()}
    kw = dict(dtc_threshold=0.7, gtc_threshold=0.7, alpha_ct=0, alpha_st=1)
    _close(tscores.compute_psds_from_scores(zero, gt, dur, **kw),
           jscores.compute_psds_from_scores(zero_j, gt, dur, **kw))
