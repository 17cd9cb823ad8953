"""Label codec: seconds <-> frame-grid multi-hot matrices (own copy of
desed_task_tpu/labels/encoder.py).

    n_frames      = int(int(audio_len * fs / frame_hop) / net_pooling)
    time_to_frame = clip(time * fs / frame_hop / net_pooling, 0, n_frames)
    frame_to_time = clip(frame * net_pooling * frame_hop / fs, 0, audio_len)

Event rows fill y[int(t2f(onset)) : int(ceil(t2f(offset))), class] = conf.
Strong labels may come as an event table (utils/table.py: a column mapping
or a DataFrame with event_label / onset / offset [/ confidence]).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Iterable, Sequence

import numpy as np

from ..utils import table as tbl


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
        self._index = {l: i for i, l in enumerate(self.labels)}

    def _time_to_frame(self, time):
        frame = np.asarray(time, dtype=np.float64) * self.fs / self.frame_hop
        return np.clip(frame / self.net_pooling, a_min=0, a_max=self.n_frames)

    def _frame_to_time(self, frame):
        t = np.asarray(frame, dtype=np.float64) * self.net_pooling * self.frame_hop / self.fs
        return np.clip(t, a_min=0, a_max=self.audio_len)

    # --- weak labels ------------------------------------------------------
    def encode_weak(self, labels) -> np.ndarray:
        """Class names (a list or a comma-joined string) -> multi-hot [C];
        the sentinel "empty" gives all -1 (unlabeled data)."""
        if isinstance(labels, str):
            if labels == "empty":
                return np.zeros(len(self.labels)) - 1
            labels = labels.split(",")
        y = np.zeros(len(self.labels))
        for label in labels:
            if not tbl.is_missing(label) and label != "":
                y[self._index[label]] = 1
        return y

    def decode_weak(self, y) -> list[str]:
        return [self.labels[i] for i, v in enumerate(np.asarray(y)) if v == 1]

    # --- strong labels ----------------------------------------------------
    def encode_strong(self, events: Iterable, confidences: Iterable | None = None) -> np.ndarray:
        """Events -> [n_frames, C]. `events` is "empty" (all -1), an
        iterable of (label, onset, offset[, confidence]) tuples or of bare
        labels (active on every frame), or an event table."""
        y = np.zeros((self.n_frames, len(self.labels)), dtype=np.float64)
        if isinstance(events, str):
            if events == "empty":
                return y - 1
            raise ValueError(f"unknown sentinel {events!r}")
        for label, onset, offset, conf in self._normalize_events(events, confidences):
            i = self._index[label]
            a = int(self._time_to_frame(onset))
            b = int(np.ceil(self._time_to_frame(offset)))
            y[a:b, i] = conf
        return y

    def encode_strong_df(self, label_df) -> np.ndarray:
        return self.encode_strong(label_df)

    def _normalize_events(self, events, confidences):
        del confidences  # as in the JAX codec: confidences ride in the events
        rows = []
        if _is_table(events):
            cols = tbl.columns(events)
            if not {"onset", "offset", "event_label"}.issubset(cols):
                raise ValueError("an event table must have onset/offset/event_label")
            n = tbl.n_rows(events)
            confs = tbl.column(events, "confidence") if "confidence" in cols else np.ones(n)
            for l, a, b, c in zip(events["event_label"], events["onset"], events["offset"],
                                  confs):
                if not tbl.is_missing(l):
                    rows.append((l, float(a), float(b), float(c)))
            return rows
        for ev in events:
            if isinstance(ev, str):
                if ev != "":
                    rows.append((ev, 0.0, self.audio_len, 1.0))
            elif len(ev) == 3:
                if ev[0] != "":
                    rows.append((ev[0], float(ev[1]), float(ev[2]), 1.0))
            elif len(ev) == 4:
                if ev[0] != "":
                    rows.append((ev[0], float(ev[1]), float(ev[2]), float(ev[3])))
            else:
                raise NotImplementedError(f"cannot encode event {ev!r}")
        return rows

    def decode_strong(self, y: np.ndarray) -> list[list]:
        """[n_frames, C] activity -> [[label, onset_sec, offset_sec], ...]."""
        from .events import decode_strong_array

        return decode_strong_array(np.asarray(y), self.labels, frame_to_time=self._frame_to_time)

    # --- persistence ------------------------------------------------------
    def state_dict(self):
        return {
            "labels": self.labels,
            "audio_len": self.audio_len,
            "frame_len": self.frame_len,
            "frame_hop": self.frame_hop,
            "net_pooling": self.net_pooling,
            "fs": self.fs,
        }

    @classmethod
    def load_state_dict(cls, state):
        return cls(state["labels"], state["audio_len"], state["frame_len"], state["frame_hop"],
                   state["net_pooling"], state["fs"])


class CatManyHotEncoder(ManyHotEncoder):
    """Concatenation of encoders on one frame grid; a label in several
    encoders is kept once, at its first place."""

    def __init__(self, encoders: Sequence[ManyHotEncoder], allow_same_classes=True):
        if not encoders:
            raise ValueError("encoders list must not be empty.")
        first = encoders[0]
        for enc in encoders:
            for attr in ("audio_len", "frame_len", "frame_hop", "net_pooling", "fs"):
                if getattr(first, attr) != getattr(enc, attr):
                    raise ValueError("Encoders must share frame-grid args (fs, hop, ...)")
        total, seen, dup = [], set(), False
        for enc in encoders:
            for label in enc.labels:
                if label in seen:
                    dup = True
                    continue
                seen.add(label)
                total.append(label)
        if dup and not allow_same_classes:
            raise RuntimeError("Encoders must not have classes in common.")
        super().__init__(total, first.audio_len, first.frame_len, first.frame_hop,
                         first.net_pooling, first.fs)


def _is_table(obj) -> bool:
    """A column mapping (dict) or a DataFrame, as opposed to an iterable of
    event tuples."""
    return isinstance(obj, dict) or (type(obj).__name__ == "DataFrame" and hasattr(obj, "columns"))
