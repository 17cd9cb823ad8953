"""MAESTRO long-form scoring: clip windows -> file-level segment scores
(own copy of desed_task_tpu/inference/maestro.py, without pandas).

Windowed clips named `{file_id}-{onset_cs}-{offset_cs}` are scored per clip;
their 1-s segment scores are overlap-added into the full-file timeline with
summand-count averaging, and clip-level ground truths are shifted back to
file time with per-class merging of overlapping events.

Score inputs are score tables (a DataFrame or a column mapping with onset,
offset and one column per class) or decode's `ScoreCurve` tuples; the
outputs are ScoreCurves with `as_arrays=True`, else DataFrames (pandas is
imported then).
"""

from __future__ import annotations

from collections import defaultdict
from math import ceil

import numpy as np

from .decode import ScoreCurve, as_score_curve, create_score_dataframe, validate_score_dataframe


def merge_overlapping_events(ground_truth_events: dict) -> dict:
    """Per class, merge overlapping/adjacent (onset, offset, class) events."""
    for clip_id, events in ground_truth_events.items():
        per_class = defaultdict(list)
        for ev in events:
            per_class[ev[2]].append(ev)
        merged_all = []
        for _, evs in per_class.items():
            evs = sorted(evs)
            merged = []
            current_offset = -1e6
            for ev in evs:
                if ev[0] > current_offset:
                    merged.append(list(ev))
                else:
                    merged[-1][1] = max(current_offset, ev[1])
                current_offset = merged[-1][1]
            merged_all.extend(merged)
        ground_truth_events[clip_id] = merged_all
    return ground_truth_events


def merge_maestro_ground_truth(clip_ground_truth: dict) -> dict:
    """{clip_id: [(onset, offset, class)]} with window-relative times ->
    {file_id: merged file-time events}. Clip ids are
    `{file}-{onset_cs}-{offset_cs}` (centiseconds)."""
    ground_truth = defaultdict(list)
    for clip_id, events in clip_ground_truth.items():
        file_id, clip_onset, _ = clip_id.rsplit("-", maxsplit=2)
        t0 = int(clip_onset) // 100
        ground_truth[file_id].extend(
            [(t0 + on, t0 + off, cls) for on, off, cls in events]
        )
    return merge_overlapping_events(dict(ground_truth))


def _segment_pool_mean(
    timestamps: np.ndarray,  # [T+1]
    values: np.ndarray,  # [T, C]
    clip_length: float,
    segment_length: float,
) -> np.ndarray:
    """Duration-weighted mean of piecewise-constant scores per segment.

    Vectorized as one pooling-matrix GEMM: W[s, r] = overlap of segment s
    with frame row r, normalized per segment."""
    seg_onsets = np.arange(0.0, clip_length, segment_length)
    seg_offsets = seg_onsets + segment_length
    lo = np.maximum(timestamps[None, :-1], seg_onsets[:, None])
    hi = np.minimum(timestamps[None, 1:], seg_offsets[:, None])
    w = np.maximum(0.0, hi - lo)  # [n_seg, T]
    return (w @ values) / w.sum(1, keepdims=True)


def get_segment_scores(scores_df, clip_length: float, segment_length: float = 1.0):
    """Duration-weighted mean of piecewise-constant frame scores per segment."""
    frame_timestamps, event_classes = validate_score_dataframe(scores_df)
    scores_arr = as_score_curve(scores_df).values
    seg = _segment_pool_mean(frame_timestamps, scores_arr, clip_length, segment_length)
    seg_times = np.r_[np.arange(0.0, clip_length, segment_length), clip_length]
    return create_score_dataframe(seg, seg_times, event_classes)


def get_segment_scores_and_overlap_add(
    frame_scores: dict,
    audio_durations: dict,
    event_classes: list[str],
    segment_length: float = 1.0,
    as_arrays: bool = False,
) -> dict:
    """Overlap-add windowed clip scores into file-level segment scores.

    frame_scores: {f"{file_id}-{onset_cs}-{offset_cs}": score table or
    ScoreCurve}. Returns {file_id: segment score DataFrame
    covering [0, duration]} — or (timestamps, values) tuples when
    ``as_arrays=True``.
    """
    segment_scores_file: dict[str, np.ndarray] = {}
    summand_count: dict[str, np.ndarray] = {}
    skipped: set[str] = set()
    pool_cache: dict = {}
    for clip_id, curve in frame_scores.items():
        file_id, clip_onset, clip_offset = clip_id.rsplit("-", maxsplit=2)
        if file_id not in audio_durations:
            # callers derive durations from ground truth; windows of files
            # with no (surviving) gt events have no timeline to land on and
            # are excluded from the metrics anyway — but surface the skips so
            # a merely-incomplete durations table is detectable
            skipped.add(file_id)
            continue
        t0 = float(clip_onset) / 100
        t1 = float(clip_offset) / 100
        if file_id not in segment_scores_file:
            n_seg = ceil(audio_durations[file_id] / segment_length)
            segment_scores_file[file_id] = np.zeros((n_seg, len(event_classes)))
            summand_count[file_id] = np.zeros((n_seg, len(event_classes)))
        curve = as_score_curve(curve)
        ts, vals = curve.timestamps, curve.select(event_classes)
        # the weight matrix depends only on (grid, clip length): cache it
        key = (ts.shape[0], float(ts[-1]), t1 - t0)
        W = pool_cache.get(key)
        if W is None:
            seg_onsets = np.arange(0.0, t1 - t0, segment_length)
            lo = np.maximum(ts[None, :-1], seg_onsets[:, None])
            hi = np.minimum(ts[None, 1:], (seg_onsets + segment_length)[:, None])
            W = np.maximum(0.0, hi - lo)
            W = W / W.sum(1, keepdims=True)
            pool_cache[key] = W
        seg_clip = W @ vals
        i0 = int(t0 // segment_length)
        need = i0 + len(seg_clip)
        if need > len(segment_scores_file[file_id]):
            # windows may extend past the (ground-truth-derived) duration,
            # e.g. when durations come from max event offsets; grow the
            # buffer and trim back to the declared duration on return
            extra = need - len(segment_scores_file[file_id])
            pad = ((0, extra), (0, 0))
            segment_scores_file[file_id] = np.pad(segment_scores_file[file_id], pad)
            summand_count[file_id] = np.pad(summand_count[file_id], pad)
        segment_scores_file[file_id][i0:need] += seg_clip
        summand_count[file_id][i0:need] += 1
    if skipped:
        import warnings

        warnings.warn(
            f"overlap-add: {len(skipped)} file_id(s) had score windows but no "
            f"entry in audio_durations and were dropped from the metrics "
            f"(e.g. {sorted(skipped)[:3]})",
            stacklevel=2,
        )
    out = {}
    for file_id in segment_scores_file:
        n_seg = ceil(audio_durations[file_id] / segment_length)
        vals = (
            segment_scores_file[file_id] / np.maximum(summand_count[file_id], 1)
        )[:n_seg]
        ts = np.minimum(
            np.arange(0.0, audio_durations[file_id] + segment_length, segment_length),
            audio_durations[file_id],
        )[: n_seg + 1]
        out[file_id] = (
            ScoreCurve(ts, vals, tuple(event_classes))
            if as_arrays
            else create_score_dataframe(vals, ts, event_classes)
        )
    return out
