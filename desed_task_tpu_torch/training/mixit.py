"""MixIT: mixture-invariant training for unsupervised separation
(counterpart of desed_task_tpu/training/mixit.py).

Feed the model a mixture of two mixtures x = x1 + x2; it estimates M
sources s_1..s_M; the loss is the best (minimum) over all 2^M binary
assignments A in {0,1}^{2 x M} with exactly one '1' per column of
sum_i loss(x_i, [A s]_i) (Wisdom et al. 2020). The assignments are one
static [2^M, 2, M] tensor contracted with the estimates: no data-dependent
control flow.

Loss: negative thresholded SNR, tau = 10^(-snr_max/10):
  -10 log10( ||t||^2 / (||t - e||^2 + tau ||t||^2) ).
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def _assignments(n_src: int) -> np.ndarray:
    """[2^M, 2, M] one-hot-per-column binary assignment matrices."""
    combos = []
    for bits in range(2 ** n_src):
        a = np.zeros((2, n_src), np.float32)
        for m in range(n_src):
            a[(bits >> m) & 1, m] = 1.0
        combos.append(a)
    return np.stack(combos)


def assignments(n_src: int, device, dtype=torch.float32) -> torch.Tensor:
    """_assignments(n_src) as a tensor on `device`."""
    return torch.as_tensor(_assignments(n_src), dtype=dtype, device=device)


def neg_thresholded_snr(target: torch.Tensor, est: torch.Tensor, snr_max: float = 30.0):
    """-10 log10(||t||^2 / (||t-e||^2 + tau ||t||^2)) over the last axis:
    target / est [..., N] -> [...]."""
    tau = 10.0 ** (-snr_max / 10.0)
    t2 = torch.sum(target * target, -1)
    err = torch.sum((target - est) ** 2, -1)
    return -10.0 * torch.log10(t2 / (err + tau * t2 + 1e-12) + 1e-12)


def remix(est_sources: torch.Tensor) -> torch.Tensor:
    """est_sources [B, M, N] -> the remixes under every assignment [B, K, 2, N]."""
    A = assignments(est_sources.shape[1], est_sources.device, est_sources.dtype)
    return torch.einsum("kam,bmn->bkan", A, est_sources)


def mixit_loss(est_sources: torch.Tensor, mixtures: torch.Tensor, snr_max: float = 30.0):
    """est_sources [B, M, N], mixtures [B, 2, N] -> (scalar loss, the best
    assignment's index per example [B]; ties keep the first)."""
    per = neg_thresholded_snr(mixtures[:, None], remix(est_sources), snr_max)  # [B, K, 2]
    per_assignment = per.sum(-1)  # [B, K]
    idx = torch.argmin(per_assignment, dim=1)
    best = per_assignment.gather(1, idx[:, None])[:, 0]
    return best.mean(), idx


def mixture_of_mixtures(audio: torch.Tensor):
    """[2B, N] batch of mixtures -> (moms [B, N], pairs [B, 2, N])."""
    b2, n = audio.shape
    if b2 % 2:
        raise ValueError("need an even batch to form mixtures of mixtures")
    pairs = audio.reshape(b2 // 2, 2, n)
    return pairs.sum(1), pairs
