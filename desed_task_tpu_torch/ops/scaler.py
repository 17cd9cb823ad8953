"""Feature normalization (counterpart of desed_task_tpu/ops/scaler.py).

Instance statistics are computed per clip; dataset statistics come from a
fitted `ScalerState`. The 2024 conf uses instance min-max
(recipes/dcase2024_task4_baseline/confs/pretrained.yaml:33-36). A clip with
hi == lo (a zero-padded clip) maps to -1, not NaN, as in the JAX module.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Iterable

import numpy as np
import torch

from ..obs.profiling import span


@dataclasses.dataclass(frozen=True)
class ScalerConfig:
    statistic: str = "instance"  # "instance" | "dataset" | "none"
    normtype: str = "minmax"  # "standard" | "mean" | "minmax" | "none"
    dims: tuple[int, ...] = (1, 2)
    eps: float = 1e-8


@dataclasses.dataclass
class ScalerState:
    """Fitted statistics for statistic="dataset" (else empty)."""

    mean: torch.Tensor | None = None
    mean_squared: torch.Tensor | None = None


def fit_scaler(
    cfg: ScalerConfig, batches: Iterable, transform: Callable = lambda b: b
) -> ScalerState:
    """Stream mean / mean-of-squares over an iterator of feature batches
    (per-batch mean over cfg.dims, then over the batch axis, averaged)."""
    mean = mean_sq = None
    n = 0
    for batch in batches:
        feats = np.asarray(transform(batch))
        m = feats.mean(axis=cfg.dims, keepdims=True).mean(0)[None]
        m2 = (feats**2).mean(axis=cfg.dims, keepdims=True).mean(0)[None]
        mean = m if mean is None else mean + m
        mean_sq = m2 if mean_sq is None else mean_sq + m2
        n += 1
    if n == 0:
        raise ValueError("fit_scaler received an empty iterator")
    return ScalerState(torch.as_tensor(mean / n), torch.as_tensor(mean_sq / n))


def apply_scaler(
    x: torch.Tensor, cfg: ScalerConfig, state: ScalerState | None = None
) -> torch.Tensor:
    """Normalize features [B, n_mels, T]."""
    with span("frontend.scaler"):
        if cfg.statistic in ("none", None) or cfg.normtype in ("none", None):
            return x
        dims = tuple(cfg.dims)
        if cfg.statistic == "dataset":
            if state is None or state.mean is None:
                raise ValueError("dataset scaler must be fitted (ScalerState)")
            mean = state.mean.to(x.device, x.dtype)
            if cfg.normtype == "mean":
                return x - mean
            if cfg.normtype == "standard":
                mean_sq = state.mean_squared.to(x.device, x.dtype)
                std = torch.sqrt(mean_sq - mean**2)
                return (x - mean) / (std + cfg.eps)
            raise NotImplementedError(
                "statistic=dataset supports normtype mean|standard (as reference)"
            )
        if cfg.normtype == "mean":
            return x - x.mean(dim=dims, keepdim=True)
        if cfg.normtype == "standard":
            mu = x.mean(dim=dims, keepdim=True)
            # torch.std's unbiased (ddof=1) estimator, as the reference
            cnt = math.prod(x.shape[d] for d in dims)
            var = ((x - mu) ** 2).sum(dim=dims, keepdim=True) / max(cnt - 1, 1)
            return (x - mu) / (torch.sqrt(var) + cfg.eps)
        if cfg.normtype == "minmax":
            lo = x.amin(dim=dims, keepdim=True)
            hi = x.amax(dim=dims, keepdim=True)
            return (x - lo) / (hi - lo + cfg.eps) * 2.0 - 1.0
        raise ValueError(f"unknown normtype {cfg.normtype!r}")
