"""Batch assembly (own copy of `collate` from desed_task_tpu/data/batcher.py;
its samplers and multi-source batcher belong to the train side of the port)."""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np


def collate(items: Sequence[Mapping[str, np.ndarray]]) -> dict:
    """Stack a list of per-item dicts into arrays (string fields listed)."""
    out = {}
    for key in items[0]:
        vals = [it[key] for it in items]
        if isinstance(vals[0], (str, bytes)):
            out[key] = list(vals)
        else:
            out[key] = np.stack([np.asarray(v) for v in vals])
    return out
