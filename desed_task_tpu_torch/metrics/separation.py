"""Separation quality: SI-SNR and MixIT-style SI-SNR improvement
(counterpart of desed_task_tpu/metrics/separation.py).

Given two-source mixtures with known ground truth, a separator is scored by
the best assignment of its M estimates into the 2 reference sources, the
evaluation protocol of the MixIT paper (Wisdom et al. 2020).
"""

from __future__ import annotations

import torch

from ..training.mixit import remix

_EPS = 1e-8


def si_snr(target: torch.Tensor, estimate: torch.Tensor) -> torch.Tensor:
    """Scale-invariant SNR in dB over the last axis: target / estimate
    [..., N] -> [...]. Both are mean-removed; the estimate is projected onto
    the target, so any rescaling of it leaves the value unchanged."""
    t = target - torch.mean(target, -1, keepdim=True)
    e = estimate - torch.mean(estimate, -1, keepdim=True)
    dot = torch.sum(e * t, -1, keepdim=True)
    t_energy = torch.sum(t * t, -1, keepdim=True)
    s_target = dot * t / (t_energy + _EPS)
    noise = e - s_target
    ratio = torch.sum(s_target ** 2, -1) / (torch.sum(noise ** 2, -1) + _EPS)
    return 10.0 * torch.log10(ratio + _EPS)


def best_assignment_si_snr(sources: torch.Tensor, estimates: torch.Tensor) -> torch.Tensor:
    """sources [B, 2, N] (the ground-truth pair), estimates [B, M, N] -> the
    best assignment's mean-over-pair SI-SNR [B]."""
    per = si_snr(sources[:, None], remix(estimates))  # [B, K, 2]
    return torch.amax(per.mean(-1), dim=1)


def si_snr_improvement(sources: torch.Tensor, estimates: torch.Tensor,
                       mixture: torch.Tensor) -> torch.Tensor:
    """SI-SNRi [B]: the best-assignment SI-SNR less the mixture's own SI-SNR
    against each reference source (no processing)."""
    baseline = si_snr(sources, mixture[:, None]).mean(-1)
    return best_assignment_si_snr(sources, estimates) - baseline
