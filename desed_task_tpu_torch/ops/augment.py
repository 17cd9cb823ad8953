"""Data augmentations with an explicit generator (counterpart of
desed_task_tpu/ops/augment.py).

mixup, frame_shift, add_noise, and the torchaudio TimeMasking used for
SpecAugment and the recurrent dropstep, as tensor functions that run on the
batch's device. Every draw comes from the caller's `torch.Generator` (on the
data's device). The streams differ from JAX's, so each function also takes
its draws as optional arguments (`u`, `noise`, `perm`, `c`): the tests feed
both packages the same numbers. Distributions are the JAX module's: one
Beta(0.2, 0.2) mixup coefficient shared by the batch, a per-example
Gauss(0, 90) frame shift, a uniform 6-30 dB SNR, and float mask lengths
U[0, mask_param') with starts U[0, len - length) (augment.py:126-140).

`torch.distributions.Beta` takes no generator: the mixup coefficient is
drawn on the host from a numpy Generator (`host_rng`).
"""

from __future__ import annotations

import math

import numpy as np
import torch


def host_rng(generator: torch.Generator) -> np.random.Generator:
    """A numpy Generator seeded by one draw from `generator` (a host sync
    when the generator lives on the card)."""
    seed = torch.randint(0, 2**62, (1,), generator=generator, device=generator.device)
    return np.random.default_rng(int(seed.item()))


def mixup(generator, data, target=None, alpha: float = 0.2, beta: float = 0.2,
          mixup_label_type: str = "soft", perm=None, c=None):
    """Batch mixup with one shared Beta(alpha, beta) coefficient.

    Returns (mixed, (perm, c)) or, with `target`, (mixed, mixed_target,
    (perm, c)); pass `perm` / `c` to mix several tensors of a batch alike.
    """
    if c is None:
        c = float(host_rng(generator).beta(alpha, beta))
    if perm is None:
        perm = torch.randperm(data.shape[0], generator=generator, device=data.device)
    mixed = c * data + (1.0 - c) * data[perm]
    if target is None:
        return mixed, (perm, c)
    if mixup_label_type == "soft":
        mixed_t = torch.clamp(c * target + (1.0 - c) * target[perm], 0.0, 1.0)
    elif mixup_label_type == "hard":
        mixed_t = torch.clamp(target + target[perm], 0.0, 1.0)
    else:
        raise NotImplementedError(f"mixup_label_type {mixup_label_type!r}")
    return mixed, mixed_t, (perm, c)


def _roll_rows(x, shifts, axis: int):
    """Per-example jnp.roll along `axis`: out[b, ..., i] = x[b, ..., (i - s_b) mod n]."""
    xt = x.movedim(axis, -1)
    n = xt.shape[-1]
    idx = (torch.arange(n, device=x.device)[None, :] - shifts[:, None]) % n
    idx = idx.view(x.shape[0], *([1] * (xt.dim() - 2)), n).expand_as(xt)
    return xt.gather(-1, idx).movedim(-1, axis)


def frame_shift(generator, mels, labels, net_pooling: int = 4, std: float = 90.0,
                label_axis: int = -1, noise=None):
    """Per-example circular time shift: round(Gauss(0, std)) frames on the
    features [B, n_mels, T]; labels by shift // net_pooling, toward zero for
    negative shifts (data_augm.frame_shift)."""
    if noise is None:
        noise = torch.randn(mels.shape[0], generator=generator, device=mels.device)
    shifts = torch.round(noise * std).to(torch.int64)
    lab = torch.where(shifts < 0, -(shifts.abs() // net_pooling), shifts // net_pooling)
    return _roll_rows(mels, shifts, -1), _roll_rows(labels, lab, label_axis)


def add_noise(generator, mels, snrs: tuple[float, float] = (6.0, 30.0),
              dims: tuple[int, ...] = (1, 2), u=None, noise=None):
    """White noise at a per-example uniform SNR (dB) against the feature std
    (unbiased, as torch.std)."""
    b = mels.shape[0]
    shape = (b,) + (1,) * (mels.dim() - 1)
    if u is None:
        u = torch.rand(shape, generator=generator, device=mels.device)
    snr = 10.0 ** (((snrs[0] - snrs[1]) * u + snrs[1]) / 20.0)
    n = math.prod(mels.shape[d] for d in dims)
    mu = mels.mean(dim=dims, keepdim=True)
    sigma = torch.sqrt(((mels - mu) ** 2).sum(dim=dims, keepdim=True) / max(n - 1, 1)) / snr
    if noise is None:
        noise = torch.randn(mels.shape, generator=generator, device=mels.device)
    return mels + noise * sigma


def time_mask(generator, x, mask_param: int, p: float = 1.0, axis: int = -1,
              mask_value: float = 0.0, shared: bool = False, u=None):
    """torchaudio TimeMasking(iid_masks=True) on any axis, float semantics.

    Per example: length = U * mask_param', mask_param' = min(mask_param,
    int(len * p)) when p < 1; start = U' * (len - length); positions with
    start <= i < start + length get `mask_value`. `shared=True` draws one
    mask for the whole batch. `u` [2, b] gives the two uniforms (b = 1 when
    shared, else the batch).
    """
    axis = axis % x.dim()
    length = x.shape[axis]
    eff = mask_param if p >= 1.0 else min(mask_param, int(length * p))
    if eff <= 0:
        return x
    b = 1 if shared else x.shape[0]
    if u is None:
        u = torch.rand((2, b), generator=generator, device=x.device)
    val = u[0] * eff
    start = u[1] * (length - val)
    idx = torch.arange(length, dtype=torch.float32, device=x.device)
    mask = (idx[None, :] >= start[:, None]) & (idx[None, :] < (start + val)[:, None])
    shape = [1] * x.dim()
    shape[0] = b
    shape[axis] = length
    return x.masked_fill(mask.view(shape), mask_value)


def specaugment(generator, x, t_l: int, t_p: float, f_l: int, f_p: float,
                shared: bool = False, u=None):
    """A frequency mask then a time mask on x [B, n_mels, T]
    (CRNN.apply_specaugment); `u` = (u_freq, u_time), each as time_mask's."""
    uf, ut = (None, None) if u is None else u
    x = time_mask(generator, x, f_l, f_p, axis=1, shared=shared, u=uf)
    return time_mask(generator, x, t_l, t_p, axis=2, shared=shared, u=ut)
