"""The port's decode, label codec, median-filter callable, MAESTRO scoring,
score files and collate against the JAX package's, on the same seeded
scores: identical output."""

import numpy as np
import pandas as pd
import pytest

from desed_task_tpu.data.batcher import collate as jcollate
from desed_task_tpu.inference import decode as jdecode
from desed_task_tpu.inference import io as jio
from desed_task_tpu.inference import maestro as jmaestro
from desed_task_tpu.labels import encoder as jenc
from desed_task_tpu.labels.events import decode_strong_array as jdecode_strong_array
from desed_task_tpu.ops.median import ClassWiseMedianFilter as JMedian
from desed_task_tpu_torch.data.batcher import collate as tcollate
from desed_task_tpu_torch.inference import decode as tdecode
from desed_task_tpu_torch.inference import io as tio
from desed_task_tpu_torch.inference import maestro as tmaestro
from desed_task_tpu_torch.labels import encoder as tenc
from desed_task_tpu_torch.labels.events import decode_strong_array as tdecode_strong_array
from desed_task_tpu_torch.ops.median import ClassWiseMedianFilter as TMedian

CLASSES = ["Alarm_bell_ringing", "Blender", "Cat", "Dishes", "Dog"]
ENC = (CLASSES, 10, 2048, 256, 4, 16000)
B, T = 5, 156


def _scores(seed=0):
    r = np.random.default_rng(seed)
    s = r.random((B, len(CLASSES), T))
    k = np.ones(7) / 7
    return np.apply_along_axis(lambda v: np.convolve(v, k, mode="same"), -1, s).astype(np.float32)


def _names():
    return [f"dir/clip_{i}.wav" for i in range(B)]


def _same_table(t, df):
    """A port event table and a JAX DataFrame hold the same rows."""
    assert list(t) == ["event_label", "onset", "offset", "filename"] == list(df.columns)
    for c in df.columns:
        assert list(t[c]) == list(df[c]), c


def _same_curves(t, j):
    assert list(t) == list(j)
    for k in j:
        if isinstance(j[k], pd.DataFrame):
            pd.testing.assert_frame_equal(t[k], j[k])
        else:
            assert isinstance(t[k], tdecode.ScoreCurve)
            np.testing.assert_array_equal(t[k].timestamps, j[k].timestamps)
            np.testing.assert_array_equal(t[k].values, j[k].values)
            assert t[k].values.dtype == j[k].values.dtype and t[k].classes == j[k].classes


@pytest.mark.parametrize("median", ["none", "list", "callable", "post"])
@pytest.mark.parametrize("gates", [(True, True), (True, False), (False, True), (False, False)])
@pytest.mark.parametrize("as_arrays", [False, True])
def test_batched_decode_preds_matches_jax(median, gates, as_arrays):
    scores = _scores()
    kw = dict(thresholds=(0.3, 0.5, 0.6), want_raw=gates[0], want_post=gates[1],
              as_arrays=as_arrays)
    windows = [3, 5, 1, 7, 4]
    tkw, jkw = dict(kw), dict(kw)
    if median == "list":
        tkw["median_filter"] = jkw["median_filter"] = windows
    elif median == "callable":
        tkw["median_filter"], jkw["median_filter"] = TMedian(windows), JMedian(windows)
    elif median == "post":
        post = _scores(1)
        tkw["post_preds"] = jkw["post_preds"] = post
    t = tdecode.batched_decode_preds(scores, _names(), tenc.ManyHotEncoder(*ENC), **tkw)
    j = jdecode.batched_decode_preds(scores, _names(), jenc.ManyHotEncoder(*ENC), **jkw)
    _same_curves(t[0], j[0])
    _same_curves(t[1], j[1])
    assert list(t[2]) == list(j[2])
    for th in j[2]:
        assert len(j[2][th]) > 0
        _same_table(t[2][th], j[2][th])


def test_batched_decode_with_padding_matches_jax():
    scores = _scores(2)
    pad = [1.0, 0.5, 0.25, 0.9, 0.0]
    kw = dict(thresholds=(0.5,), median_filter=[3] * 5, pad_indx=pad)
    for as_arrays in (False, True):
        t = tdecode.batched_decode_preds(scores, _names(), tenc.ManyHotEncoder(*ENC),
                                         as_arrays=as_arrays, **kw)
        j = jdecode.batched_decode_preds(scores, _names(), jenc.ManyHotEncoder(*ENC),
                                         as_arrays=as_arrays, **kw)
        _same_curves(t[0], j[0])
        _same_curves(t[1], j[1])
        _same_table(t[2][0.5], j[2][0.5])


def test_decode_without_events_gives_an_empty_table():
    t = tdecode.batched_decode_preds(np.zeros((2, 5, 10), np.float32), ["a.wav", "b.wav"],
                                     tenc.ManyHotEncoder(*ENC), thresholds=(0.5,))
    assert all(len(v) == 0 for v in t[2][0.5].values())


def test_score_curves_round_trip_through_dataframes():
    curve = tdecode.ScoreCurve(np.arange(6) * 0.5, _scores()[0].T[:5], tuple(CLASSES))
    df = curve.to_dataframe()
    pd.testing.assert_frame_equal(df, jdecode.ScoreCurve(*curve).to_dataframe())
    for src in (df, {c: df[c].to_numpy() for c in df.columns}):
        back = tdecode.as_score_curve(src)
        np.testing.assert_array_equal(back.timestamps, curve.timestamps)
        np.testing.assert_array_equal(back.values, curve.values)
        assert back.classes == curve.classes
    np.testing.assert_array_equal(curve.select(CLASSES[::-1]), curve.values[:, ::-1])


def test_events_from_activity_matches_jax():
    act = _scores(3)[0].T > 0.5
    assert (tdecode._events_from_activity(act, tenc.ManyHotEncoder(*ENC), "x.wav")
            == jdecode._events_from_activity(act, jenc.ManyHotEncoder(*ENC), "x.wav"))


def _gt_rows():
    return [("Cat", 0.5, 2.25), ("Dog", 3.0, 9.999), ("Cat", 1.0, 1.5), ("Dishes", 9.5, 12.0),
            ("Blender", -1.0, 0.3)]


def test_encode_strong_matches_jax():
    t, j = tenc.ManyHotEncoder(*ENC), jenc.ManyHotEncoder(*ENC)
    rows = _gt_rows()
    df = pd.DataFrame(rows, columns=["event_label", "onset", "offset"])
    df.loc[len(df)] = [np.nan, np.nan, np.nan]
    df_conf = df.assign(confidence=np.linspace(0.1, 0.9, len(df)))
    table = {c: df_conf[c].to_numpy() for c in df_conf.columns}
    for events in (rows, [r + (0.7,) for r in rows], ["Cat", "", "Dog"], df, df_conf, "empty",
                   [("", 1.0, 2.0)]):
        np.testing.assert_array_equal(t.encode_strong(events), j.encode_strong(events))
    np.testing.assert_array_equal(t.encode_strong(table), j.encode_strong(df_conf))
    np.testing.assert_array_equal(t.encode_strong_df(df), j.encode_strong_df(df))
    with pytest.raises(ValueError):
        t.encode_strong("x")
    with pytest.raises(NotImplementedError):
        t.encode_strong([("Cat", 1.0)])


def test_encode_weak_and_decode_match_jax():
    t, j = tenc.ManyHotEncoder(*ENC), jenc.ManyHotEncoder(*ENC)
    for labels in (["Cat", "Dog"], "Cat,Dishes", "empty", ["Cat", np.nan, None, ""], []):
        np.testing.assert_array_equal(t.encode_weak(labels), j.encode_weak(labels))
    y = j.encode_weak("Cat,Dishes")
    assert t.decode_weak(y) == j.decode_weak(y) == ["Cat", "Dishes"]
    strong = j.encode_strong(_gt_rows())
    assert t.decode_strong(strong) == j.decode_strong(strong)
    act = _scores(4)[0].T > 0.5
    assert tdecode_strong_array(act, CLASSES) == jdecode_strong_array(act, CLASSES)
    f2t = lambda f: f * 0.064
    assert tdecode_strong_array(act, CLASSES, f2t) == jdecode_strong_array(act, CLASSES, f2t)


def test_encoder_state_dict_and_cat_encoder_match_jax():
    t = tenc.ManyHotEncoder(*ENC)
    assert t.state_dict() == jenc.ManyHotEncoder(*ENC).state_dict()
    back = tenc.ManyHotEncoder.load_state_dict(t.state_dict())
    assert back.state_dict() == t.state_dict() and back.n_frames == t.n_frames
    second = (["Dog", "Speech", "Cat", "Frying"], 10, 2048, 256, 4, 16000)
    tc = tenc.CatManyHotEncoder([t, tenc.ManyHotEncoder(*second)])
    jc = jenc.CatManyHotEncoder([jenc.ManyHotEncoder(*ENC), jenc.ManyHotEncoder(*second)])
    assert tc.labels == jc.labels and tc.n_frames == jc.n_frames
    np.testing.assert_array_equal(tc.encode_strong([("Frying", 1, 3), ("Cat", 2, 4)]),
                                  jc.encode_strong([("Frying", 1, 3), ("Cat", 2, 4)]))
    with pytest.raises(RuntimeError):
        tenc.CatManyHotEncoder([t, tenc.ManyHotEncoder(*second)], allow_same_classes=False)
    with pytest.raises(ValueError):
        tenc.CatManyHotEncoder([t, tenc.ManyHotEncoder(CLASSES, 10, 2048, 128, 4, 16000)])


def test_median_filter_callable_matches_jax():
    x = _scores(5)[0].T  # [T, C]
    for windows in ([1, 1, 1, 1, 1], [3, 5, 1, 7, 4], [27] * 5):
        np.testing.assert_array_equal(TMedian(windows)(x), JMedian(windows)(x))


def _maestro_curves(as_frames):
    r = np.random.default_rng(6)
    curves = {}
    for fid, n_win in (("fileA", 4), ("fileB", 3), ("nogt", 1)):
        for w in range(n_win):
            on = w * 500
            ts = np.arange(157) * 0.064
            vals = r.random((156, len(CLASSES))).astype(np.float32)
            key = f"{fid}-{on}-{on + 1000}"
            curves[key] = (jdecode.create_score_dataframe(vals, ts, CLASSES) if as_frames
                           else jdecode.ScoreCurve(ts, vals, tuple(CLASSES)))
    return curves


@pytest.mark.parametrize("as_frames", [False, True])
@pytest.mark.parametrize("as_arrays", [False, True])
def test_overlap_add_matches_jax(as_frames, as_arrays):
    curves = _maestro_curves(as_frames)
    t_curves = curves if as_frames else {k: tdecode.ScoreCurve(*v) for k, v in curves.items()}
    durations = {"fileA": 25.0, "fileB": 18.5}
    kw = dict(as_arrays=as_arrays)
    with pytest.warns(UserWarning, match="overlap-add"):
        j = jmaestro.get_segment_scores_and_overlap_add(curves, durations, CLASSES, **kw)
    with pytest.warns(UserWarning, match="overlap-add"):
        t = tmaestro.get_segment_scores_and_overlap_add(t_curves, durations, CLASSES, **kw)
    _same_curves(t, j)
    with pytest.warns(UserWarning):
        j2 = jmaestro.get_segment_scores_and_overlap_add(curves, durations, CLASSES[::-1], 2.0)
    with pytest.warns(UserWarning):
        t2 = tmaestro.get_segment_scores_and_overlap_add(t_curves, durations, CLASSES[::-1], 2.0)
    _same_curves(t2, j2)


def test_maestro_ground_truth_and_segment_scores_match_jax():
    clip_gt = {"fileA-0-1000": [(1.0, 3.0, "Cat"), (2.0, 4.0, "Cat"), (5.0, 6.0, "Dog")],
               "fileA-500-1500": [(0.0, 1.0, "Cat"), (4.5, 9.0, "Dishes")],
               "fileB-0-1000": []}
    assert (tmaestro.merge_maestro_ground_truth(dict(clip_gt))
            == jmaestro.merge_maestro_ground_truth(dict(clip_gt)))
    ev = {"x": [(0.0, 2.0, "Cat"), (1.0, 3.0, "Cat"), (3.0, 4.0, "Cat"), (0.5, 1.0, "Dog")]}
    assert (tmaestro.merge_overlapping_events({k: list(v) for k, v in ev.items()})
            == jmaestro.merge_overlapping_events({k: list(v) for k, v in ev.items()}))
    df = next(iter(_maestro_curves(True).values()))
    pd.testing.assert_frame_equal(tmaestro.get_segment_scores(df, 10.0),
                                  jmaestro.get_segment_scores(df, 10.0))


def test_score_and_prediction_files_match_jax(tmp_path):
    scores = _scores(7)
    _, post_t, tables = tdecode.batched_decode_preds(
        scores, _names(), tenc.ManyHotEncoder(*ENC), thresholds=(0.25, 0.5), as_arrays=True)
    _, post_j, dfs = jdecode.batched_decode_preds(
        scores, _names(), jenc.ManyHotEncoder(*ENC), thresholds=(0.25, 0.5))
    assert tio.write_predictions(tables, tmp_path / "t") and jio.write_predictions(dfs, tmp_path / "j")
    assert tio.write_sed_scores(post_t, tmp_path / "ts") == jio.write_sed_scores(post_j, tmp_path / "js")
    for sub in ("", "s"):
        t_files = sorted(p.name for p in (tmp_path / f"t{sub}").iterdir())
        assert t_files == sorted(p.name for p in (tmp_path / f"j{sub}").iterdir())
        for name in t_files:
            t_text = (tmp_path / f"t{sub}" / name).read_text()
            assert t_text == (tmp_path / f"j{sub}" / name).read_text(), name
    back_t, back_j = tio.read_sed_scores(tmp_path / "ts"), jio.read_sed_scores(tmp_path / "js")
    assert list(back_t) == list(back_j)
    for k in back_j:
        assert list(back_t[k]) == list(back_j[k].columns)
        for c in back_j[k].columns:
            np.testing.assert_array_equal(back_t[k][c], back_j[k][c].to_numpy())
    # a written score table reads back as the same curve
    tio.write_sed_scores({k: tdecode.as_score_curve(v) for k, v in back_t.items()}, tmp_path / "t2")
    for k in back_t:
        assert (tmp_path / "t2" / f"{k}.tsv").read_text() == (tmp_path / "ts" / f"{k}.tsv").read_text()
    gt = pd.DataFrame([("a.wav", 1.0, 2.0, "Cat"), ("b.wav", np.nan, np.nan, np.nan),
                       ("dir/a.wav", 3.0, 4.5, "Dog")],
                      columns=["filename", "onset", "offset", "event_label"])
    want = jio.read_ground_truth_events(gt)
    assert tio.read_ground_truth_events(gt) == want
    assert tio.read_ground_truth_events({c: gt[c].to_numpy() for c in gt.columns}) == want


def test_collate_matches_jax():
    r = np.random.default_rng(8)
    items = [{"audio": r.random(10), "labels": r.random((3, 4)), "filename": f"f{i}.wav"}
             for i in range(3)]
    t, j = tcollate(items), jcollate(items)
    assert t["filename"] == j["filename"]
    for k in ("audio", "labels"):
        np.testing.assert_array_equal(t[k], j[k])
