"""Losses with torch.nn.BCELoss / MSELoss semantics (counterpart of
desed_task_tpu/training/losses.py)."""

from __future__ import annotations

import torch


def bce(probs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Binary cross entropy on probabilities, mean reduction; log terms are
    clamped at -100, so p in {0, 1} against the opposite target gives a
    large but finite loss (losses.py:8-18)."""
    p = probs.float()
    t = targets.float()
    log_p = torch.clamp(torch.log(p.clamp_min(0.0)), min=-100.0)
    log_1p = torch.clamp(torch.log((1.0 - p).clamp_min(0.0)), min=-100.0)
    return -(t * log_p + (1.0 - t) * log_1p).mean()


def mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return ((a.float() - b.float()) ** 2).mean()


SELF_SUP_LOSSES = {"mse": mse, "bce": bce}
