"""Dropout with an explicit generator (counterpart of desed_task_tpu/ops/dropout.py).

Two forms, as in the JAX package:

  * `packed_keep_mask`: the conv blocks' uint8 threshold masks
    (dropout.py:47-48): keep where a uniform byte < round(keep_prob * 256),
    exact for the recipes' rate 0.5 and within 1/512 otherwise. The fused
    block draws the same bytes itself (`ops.fused_cnn.fused_glu_block`), so
    the plain conv chain and the fused kernels drop the same elements when
    they draw from generators in the same state.
  * `dropout`: flax `nn.Dropout` semantics (kept elements scaled by
    1/keep_prob, dropped ones 0, identity in eval), used after `cat_tf`'s
    input, after the RNN and between RNN layers.

Every draw comes from the caller's `torch.Generator` on the tensor's device:
`torch.nn.functional.dropout` draws from the global generator and is not used.
"""

from __future__ import annotations

import torch


def keep_threshold(keep_prob: float) -> int:
    """uint8 threshold of packed_keep_mask (256 keeps every element)."""
    return min(int(round(keep_prob * 256)), 255) if keep_prob < 1.0 else 256


def random_bytes(shape, generator: torch.Generator, device=None) -> torch.Tensor:
    """Uniform uint8 draws of `shape` from `generator` (on its device)."""
    device = generator.device if device is None else device
    return torch.randint(0, 256, tuple(shape), dtype=torch.uint8, device=device,
                         generator=generator)


def packed_keep_mask(shape, keep_prob: float, generator: torch.Generator,
                     device=None) -> torch.Tensor:
    """Boolean keep-mask: uniform bytes < round(keep_prob * 256)."""
    if not 0.0 < keep_prob <= 1.0:
        raise ValueError(f"keep_prob must be in (0, 1], got {keep_prob}")
    device = generator.device if device is None else device
    if keep_prob >= 1.0:
        return torch.ones(tuple(shape), dtype=torch.bool, device=device)
    return random_bytes(shape, generator, device).to(torch.int32) < keep_threshold(keep_prob)


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator | None,
            train: bool) -> torch.Tensor:
    """flax nn.Dropout: keep with probability 1 - rate, scale kept by 1/keep."""
    if rate == 0.0 or not train:
        return x
    if generator is None:
        raise ValueError("dropout in train mode needs a torch.Generator")
    if rate >= 1.0:
        return torch.zeros_like(x)
    keep_prob = 1.0 - rate
    keep = torch.rand(x.shape, generator=generator, device=x.device) < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros_like(x))
