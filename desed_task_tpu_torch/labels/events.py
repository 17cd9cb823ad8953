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
