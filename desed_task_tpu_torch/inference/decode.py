"""Prediction decoding: frame scores -> score curves + event tables (own copy
of desed_task_tpu/inference/decode.py, without pandas).

  * median filtering is one numpy pass over the batch
    (ops/median.classwise_median_filter_np), unless the caller hands in
    scores already filtered on the card (`post_preds`);
  * event extraction for all clips and classes is one padded np.diff +
    argwhere per threshold;
  * score curves are `ScoreCurve` numpy tuples with `as_arrays=True`, else
    sed_scores_eval-style DataFrames (pandas is imported then, and only
    then).

Returns (scores_raw, scores_postprocessed, prediction tables), the tables
keyed by threshold, as utils/table.py defines them.
"""

from __future__ import annotations

from pathlib import Path
from typing import NamedTuple

import numpy as np

from ..labels.encoder import ManyHotEncoder
from ..labels.events import find_contiguous_regions
from ..ops.median import classwise_median_filter_np
from ..utils import table as tbl


class ScoreCurve(NamedTuple):
    """Numpy piecewise-constant score curve (the `as_arrays=True` twin of a
    sed_scores_eval score DataFrame)."""

    timestamps: np.ndarray  # [T+1]
    values: np.ndarray  # [T, C]
    classes: tuple  # class name per column

    def select(self, event_classes) -> np.ndarray:
        """[T, len(event_classes)] values in the requested column order."""
        if tuple(event_classes) == tuple(self.classes):
            return self.values
        idx = [self.classes.index(c) for c in event_classes]
        return self.values[:, idx]

    def to_dataframe(self):
        return create_score_dataframe(self.values, self.timestamps, self.classes)


def create_score_dataframe(scores, timestamps, event_classes):
    """[T, C] scores + [T+1] timestamps -> DataFrame(onset, offset, classes)
    (needs pandas)."""
    import pandas as pd

    scores = np.asarray(scores)
    timestamps = np.asarray(timestamps)
    data = {"onset": timestamps[:-1], "offset": timestamps[1:]}
    for i, c in enumerate(event_classes):
        data[c] = scores[:, i]
    return pd.DataFrame(data)


def validate_score_dataframe(df):
    """(timestamps [T+1], class names) of a score table: a DataFrame or a
    column mapping with onset, offset and one column per class."""
    classes = [c for c in tbl.columns(df) if c not in ("onset", "offset")]
    timestamps = np.r_[tbl.column(df, "onset"), tbl.column(df, "offset")[-1]]
    return timestamps, classes


def as_score_curve(curve) -> ScoreCurve:
    """A score table or a ScoreCurve -> ScoreCurve."""
    if isinstance(curve, ScoreCurve):
        return curve
    ts, classes = validate_score_dataframe(curve)
    values = np.stack([tbl.column(curve, c) for c in classes], axis=1)
    return ScoreCurve(ts, values, tuple(classes))


def _events_from_activity(act: np.ndarray, encoder: ManyHotEncoder, filename: str):
    """[T, C] bool -> rows (event_label, onset, offset, filename) of one clip."""
    rows = []
    for c in range(act.shape[1]):
        for a, b in find_contiguous_regions(act[:, c]):
            rows.append((encoder.labels[c], float(encoder._frame_to_time(a)),
                         float(encoder._frame_to_time(b)), filename))
    return rows


def _batched_events(post: np.ndarray, threshold: float, encoder: ManyHotEncoder,
                    filenames: list[str], true_lens: np.ndarray | None) -> dict:
    """[B, C, T] scores -> the event table at `threshold`, in clip-, class-,
    then time-major order (as the per-clip loop)."""
    B, C, T = post.shape
    act = post > threshold
    if true_lens is not None:
        act &= np.arange(T)[None, None, :] < true_lens[:, None, None]
    padded = np.zeros((B, C, T + 2), np.int8)
    padded[:, :, 1:-1] = act
    d = np.diff(padded, axis=2)  # [B, C, T+1]; +1 at starts, -1 after ends
    starts = np.argwhere(d == 1)
    ends = np.argwhere(d == -1)
    if not len(starts):
        return tbl.event_table()
    return tbl.event_table(
        event_label=np.asarray(encoder.labels, dtype=object)[starts[:, 1]],
        onset=encoder._frame_to_time(starts[:, 2]),
        offset=encoder._frame_to_time(ends[:, 2]),
        filename=np.asarray(filenames, dtype=object)[starts[:, 0]],
    )


def batched_decode_preds(
    strong_preds,
    filenames,
    encoder: ManyHotEncoder,
    thresholds=(0.5,),
    median_filter=None,
    pad_indx=None,
    want_raw: bool = True,
    want_post: bool = True,
    as_arrays: bool = False,
    post_preds=None,
):
    """strong_preds: [B, C, T] scores (numpy).

    median_filter: None | per-class window list | callable([T, C]) -> [T, C].
    Returns (scores_raw, scores_postprocessed, prediction tables).
    want_raw / want_post gate the per-clip score curves; as_arrays=True
    gives them as ScoreCurve tuples instead of DataFrames; post_preds are
    scores already filtered (median_filter is then ignored).
    """
    preds = np.asarray(strong_preds, np.float32)
    B, C, T = preds.shape
    if post_preds is not None:
        post_all = np.asarray(post_preds, np.float32)
    elif isinstance(median_filter, (list, tuple, np.ndarray)):
        post_all = classwise_median_filter_np(preds, median_filter, class_axis=-2, time_axis=-1)
    elif callable(median_filter):
        post_all = np.stack([median_filter(preds[j].T).T for j in range(B)])
    else:
        post_all = preds

    true_lens = None
    if pad_indx is not None:
        true_lens = np.asarray([int(T * float(p)) for p in pad_indx], dtype=np.int64)

    audio_ids = [Path(f).stem for f in filenames]
    event_names = [aid + ".wav" for aid in audio_ids]

    scores_raw, scores_postprocessed = {}, {}
    if want_raw or want_post:
        classes = tuple(encoder.labels)
        full_ts = encoder._frame_to_time(np.arange(T + 1))
        for j in range(B):
            t_len = T if true_lens is None else int(true_lens[j])
            ts = full_ts[: t_len + 1]
            for want, src, out in ((want_raw, preds, scores_raw),
                                   (want_post, post_all, scores_postprocessed)):
                if want:
                    vals = src[j].T[:t_len]
                    out[audio_ids[j]] = (ScoreCurve(ts, vals.copy(), classes) if as_arrays
                                         else create_score_dataframe(vals, ts, encoder.labels))

    prediction_tables = {
        th: _batched_events(post_all, th, encoder, event_names, true_lens)
        for th in thresholds
    }
    return scores_raw, scores_postprocessed, prediction_tables
