"""Event-boundary utilities (own copy of desed_task_tpu/labels/events.py)."""

from __future__ import annotations

import numpy as np


def find_contiguous_regions(activity: np.ndarray) -> np.ndarray:
    """Boundaries of runs of truthy values in a 1-D array: an [n_regions, 2]
    int array of (onset, offset) frame indices, offset exclusive."""
    activity = np.asarray(activity).astype(bool)
    change = np.diff(activity.astype(np.int8))
    onsets = np.nonzero(change == 1)[0] + 1
    offsets = np.nonzero(change == -1)[0] + 1
    if activity.size and activity[0]:
        onsets = np.concatenate(([0], onsets))
    if activity.size and activity[-1]:
        offsets = np.concatenate((offsets, [activity.size]))
    return np.stack([onsets, offsets], axis=1) if onsets.size else np.zeros((0, 2), int)


def decode_strong_array(activity: np.ndarray, labels: list[str], frame_to_time=None) -> list[list]:
    """[T, C] thresholded activity -> [[label, onset, offset], ...], class by
    class; frame_to_time maps a frame index to seconds (identity if None),
    offsets at the exclusive frame boundary."""
    out = []
    act = np.asarray(activity)
    for c in range(act.shape[1]):
        for onset, offset in find_contiguous_regions(act[:, c]):
            if frame_to_time is not None:
                onset, offset = frame_to_time(onset), frame_to_time(offset)
            out.append([labels[c], float(onset), float(offset)])
    return out
