"""Separation-ensemble SED model of the 2021 recipe (counterpart of
desed_task_tpu/models/ensemble.py).

A CRNN runs on each separated source of a clip; the per-source strong and
weak predictions are summed and clamped to 1 (the "multisrc" branch), and a
learned scalar q = sigmoid(q_logit) blends them with a frozen monaural CRNN
applied to the mixture (reference finetune_on_separated.py:24-70):

    p = q * p_multisrc + (1 - q) * p_mixture

The monaural CRNN is held outside the module's parameters and buffers, as
the JAX model takes it as separate variables: it gets no gradient, no
optimizer state, no EMA and no place in a checkpoint, it always runs in
eval mode, and a deep copy of the ensemble (the mean teacher) shares it.
"""

from __future__ import annotations

import torch
from torch import nn

from .crnn import CRNN


def flatten_sources(feats: torch.Tensor) -> torch.Tensor:
    """[B, S, F, T] -> [B*S, F, T]."""
    b, s = feats.shape[:2]
    return feats.reshape(b * s, *feats.shape[2:])


def unflatten_sum_clamp(strong, weak, n_src: int):
    """Per-source predictions -> clip predictions: the sum over sources,
    clamped to [0, 1] (finetune_on_separated.py:40-52)."""
    bs = strong.shape[0] // n_src
    strong = strong.reshape(bs, n_src, *strong.shape[1:]).sum(1)
    weak = weak.reshape(bs, n_src, *weak.shape[1:]).sum(1)
    return torch.clamp(strong, 0.0, 1.0), torch.clamp(weak, 0.0, 1.0)


class _Shared:
    """A module kept out of its owner's parameters; deep copies share it."""

    def __init__(self, module: nn.Module):
        self.module = module

    def __deepcopy__(self, memo):
        return self


class EnsembleModel(nn.Module):
    """Blend of a multisrc CRNN (trainable) and a frozen monaural CRNN
    (None: the multisrc branch alone)."""

    def __init__(self, multisrc_crnn: CRNN, monaural_crnn: CRNN | None = None):
        super().__init__()
        self.multisrc_crnn = multisrc_crnn
        self.q_logit = nn.Parameter(torch.zeros(()))
        self._monaural = None
        if monaural_crnn is not None:
            monaural_crnn.eval().requires_grad_(False)
            self._monaural = _Shared(monaural_crnn)

    @property
    def monaural(self) -> CRNN | None:
        return None if self._monaural is None else self._monaural.module

    def _apply(self, fn, *args, **kwargs):
        # .to() / .cuda() / .float() move the frozen branch too
        super()._apply(fn, *args, **kwargs)
        if self._monaural is not None:
            self._monaural.module._apply(fn, *args, **kwargs)
        return self

    def forward(self, sources: torch.Tensor, mixture: torch.Tensor,
                generator: torch.Generator | None = None):
        """sources [B, S, n_mels, T] separated-source features, mixture
        [B, n_mels, T] -> (strong [B, C, T'], weak [B, C]). The multisrc
        branch follows self.training (its random parts draw from
        `generator`); the monaural branch is always in eval mode."""
        n_src = sources.shape[1]
        strong_s, weak_s = self.multisrc_crnn(flatten_sources(sources), generator=generator)
        strong, weak = unflatten_sum_clamp(strong_s, weak_s, n_src)
        if self._monaural is not None:
            q = torch.sigmoid(self.q_logit)
            strong_m, weak_m = self._monaural.module(mixture)
            strong = q * strong + (1 - q) * strong_m
            weak = q * weak + (1 - q) * weak_m
        return strong, weak
