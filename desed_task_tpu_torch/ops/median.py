"""Class-wise median filtering (counterpart of desed_task_tpu/ops/median.py).

Semantics of scipy.ndimage.median_filter(x, (k, 1)) per class: 'reflect'
boundary, which repeats the edge sample (numpy's and jnp's pad mode
"symmetric"; torch's F.pad "reflect" does not repeat it, so the pad here is
an index map), window offsets arange(k) - k//2 (left-heavy for even k), and
for even k the mean of the two middle values, as jnp.median / np.median
(torch.median would return the lower one).
"""

from __future__ import annotations

import functools

import numpy as np
import torch


# Index tensors are cached per device: a copy from pageable host memory
# waits for the card's stream, which would stall the serving forward.
@functools.lru_cache(maxsize=64)
def _symmetric_index(n: int, window: int, device: torch.device) -> torch.Tensor:
    """Indices of a length-n axis padded for `window` in numpy 'symmetric' mode."""
    left = window // 2
    i = np.arange(-left, n + window - left - 1) % (2 * n)
    return torch.as_tensor(np.where(i >= n, 2 * n - 1 - i, i), device=device)


@functools.lru_cache(maxsize=16)
def _class_groups(filter_lengths: tuple[int, ...], device: torch.device):
    """[(window, class indices)] for each window size > 1, ascending."""
    return [
        (k, torch.as_tensor([i for i, f in enumerate(filter_lengths) if f == k],
                            device=device))
        for k in sorted(set(filter_lengths)) if k > 1
    ]


def median_filter_1d(x: torch.Tensor, window: int) -> torch.Tensor:
    """Median filter along the last axis with scipy 'reflect' boundary."""
    if window <= 1:
        return x
    idx = _symmetric_index(x.shape[-1], window, x.device)
    windows = x.index_select(-1, idx).unfold(-1, window, 1)  # [..., n, window]
    srt = windows.sort(dim=-1).values
    mid = window // 2
    if window % 2:
        return srt[..., mid]
    return 0.5 * (srt[..., mid - 1] + srt[..., mid])


def classwise_median_filter(
    scores: torch.Tensor, filter_lengths, class_axis: int = -2, time_axis: int = -1
) -> torch.Tensor:
    """Per-class median smoothing of [..., C, T] scores; classes sharing a
    window size are filtered together."""
    filter_lengths = tuple(int(f) for f in filter_lengths)
    ca = class_axis % scores.dim()
    ta = time_axis % scores.dim()
    x = torch.movedim(scores, (ca, ta), (-2, -1))
    if len(filter_lengths) != x.shape[-2]:
        raise ValueError(f"{len(filter_lengths)} windows for {x.shape[-2]} classes")
    out = x.clone()
    for k, sel in _class_groups(filter_lengths, x.device):
        out[..., sel, :] = median_filter_1d(x.index_select(-2, sel), k)
    return torch.movedim(out, (-2, -1), (ca, ta))


def classwise_median_filter_np(
    scores: np.ndarray, filter_lengths, class_axis: int = -2, time_axis: int = -1
) -> np.ndarray:
    """numpy twin of classwise_median_filter for host-side decode."""
    filter_lengths = tuple(int(f) for f in filter_lengths)
    x = np.asarray(scores)
    ca = class_axis % x.ndim
    ta = time_axis % x.ndim
    x = np.moveaxis(x, (ca, ta), (-2, -1))
    if len(filter_lengths) != x.shape[-2]:
        raise ValueError(f"{len(filter_lengths)} windows for {x.shape[-2]} classes")
    out = x.copy()
    for k in sorted(set(filter_lengths)):
        if k <= 1:
            continue
        sel = np.asarray([f == k for f in filter_lengths])
        left = k // 2
        xp = np.pad(
            x[..., sel, :], [(0, 0)] * (x.ndim - 1) + [(left, k - left - 1)],
            mode="symmetric",
        )
        win = np.lib.stride_tricks.sliding_window_view(xp, k, axis=-1)
        out[..., sel, :] = np.median(win, axis=-1)
    return np.moveaxis(out, (-2, -1), (ca, ta))


class ClassWiseMedianFilter:
    """Callable of the reference API (postprocess.py): [T, C] scores (numpy)
    -> [T, C] numpy, each class smoothed with its own window."""

    def __init__(self, filter_lens=(1, 1, 1)):
        self.filter_lens = tuple(int(f) for f in filter_lens)

    def __call__(self, x, **kwargs):
        x = torch.as_tensor(np.asarray(x, np.float32))
        out = classwise_median_filter(x, self.filter_lens, class_axis=-1, time_axis=-2)
        return out.numpy()
