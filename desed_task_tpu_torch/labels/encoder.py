"""Label codec frame math (own copy of the parts of
desed_task_tpu/labels/encoder.py that the inference pipeline uses).

    n_frames      = int(int(audio_len * fs / frame_hop) / net_pooling)
    frame_to_time = clip(frame * net_pooling * frame_hop / fs, 0, audio_len)
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Sequence

import numpy as np


class ManyHotEncoder:
    def __init__(
        self,
        labels: Sequence[str],
        audio_len: float,
        frame_len: int,
        frame_hop: int,
        net_pooling: int = 1,
        fs: int = 16000,
    ):
        if isinstance(labels, np.ndarray):
            labels = labels.tolist()
        elif isinstance(labels, (dict, OrderedDict)):
            labels = list(labels.keys())
        self.labels = list(labels)
        self.audio_len = audio_len
        self.frame_len = frame_len
        self.frame_hop = frame_hop
        self.fs = fs
        self.net_pooling = net_pooling
        self.n_frames = int(int(self.audio_len * self.fs / self.frame_hop) / self.net_pooling)

    def _time_to_frame(self, time):
        frame = np.asarray(time, dtype=np.float64) * self.fs / self.frame_hop
        return np.clip(frame / self.net_pooling, a_min=0, a_max=self.n_frames)

    def _frame_to_time(self, frame):
        t = np.asarray(frame, dtype=np.float64) * self.net_pooling * self.frame_hop / self.fs
        return np.clip(t, a_min=0, a_max=self.audio_len)
