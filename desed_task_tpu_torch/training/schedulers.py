"""Step-wise schedules (counterpart of desed_task_tpu/training/schedulers.py).

The reference's ExponentialWarmup (desed_task/utils/schedulers.py:60-104) as
a function of the step, used both as the learning rate and as the
mean-teacher consistency ramp:

    ramp:      exp(exponent * (1 - min(step, L)/L)^2),  exponent = -5
    annealing: max(min_lr/max_lr, cos((step - S) * pi / (2 * (max_steps - S))))
               once step >= S = start_annealing.

Computed in float32, as the JAX module computes it.
"""

from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class ExponentialWarmup:
    max_lr: float
    rampup_length: int
    exponent: float = -5.0
    start_annealing: int | None = None
    max_steps: int | None = None
    min_lr: float = 1e-8

    def scaling_factor(self, step) -> torch.Tensor:
        """Ramp factor in [0, 1] (a float32 tensor); `step` is a Python int
        or a tensor."""
        step = torch.as_tensor(step, dtype=torch.float32)
        if self.rampup_length == 0:
            ramp = torch.ones_like(step)
        else:
            current = torch.clamp(step, 0.0, float(self.rampup_length))
            phase = 1.0 - current / float(self.rampup_length)
            ramp = torch.exp(self.exponent * phase * phase)
        if self.start_annealing is None:
            return ramp
        if self.max_steps is None:
            raise ValueError("annealing needs max_steps")
        one = step - float(self.start_annealing)
        zero = float(self.max_steps - self.start_annealing)
        anneal = torch.clamp(torch.cos(one * math.pi / (2.0 * zero)),
                             min=self.min_lr / self.max_lr)
        return torch.where(step >= self.start_annealing, anneal, ramp)

    def __call__(self, step) -> torch.Tensor:
        """Learning rate at `step`."""
        return self.max_lr * self.scaling_factor(step)
