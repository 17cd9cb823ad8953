"""Separation-ensemble mean-teacher step of the 2021 SEPSED recipe
(counterpart of desed_task_tpu/training/sepsed.py).

Batches carry pre-separated sources: every slot's "audio" is [b, n_src, N].
Per-source linear mels are computed on the card; the mixture branch takes
the log of the source-SUM of the linear mels (not the mel of the summed
audio: reference sepsed_trainer detect, :215-223), and the EnsembleModel
(models/ensemble.py) blends the trainable multisrc CRNN with the frozen
monaural CRNN through the learned q. The mean-teacher losses are the
generic step's (BCE strong and weak, MSE consistency weighted by the
warmup ramp), without mixup or class masks, and the EMA runs over the
ensemble's trainable parameters only: the multisrc CRNN and q_logit.

The state is `mean_teacher.create_state(EnsembleModel(...), ...)`; the step
updates it in place, as `mean_teacher.make_train_step` does.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.frontend import MelConfig, amplitude_to_db, mel_spectrogram
from ..ops.scaler import ScalerConfig, apply_scaler
from .losses import SELF_SUP_LOSSES, bce
from .mean_teacher import ClipAdam, MeanTeacherConfig, MeanTeacherState, _concat_batch
from .schedulers import ExponentialWarmup


def sepsed_featurize(audio: torch.Tensor, scaler, mel_cfg: MelConfig,
                     scaler_cfg: ScalerConfig):
    """[B, n_src, N] separated waveforms -> (per-source log-mel features
    [B, n_src, n_mels, T], the mixture branch's features [B, n_mels, T]
    from the source-sum of the linear mels)."""
    b, n_src, n = audio.shape
    src_mel = mel_spectrogram(audio.reshape(b * n_src, n), mel_cfg)
    mix_mel = src_mel.reshape(b, n_src, *src_mel.shape[1:]).sum(1)
    log_scale = lambda m: apply_scaler(amplitude_to_db(m, mel_cfg), scaler_cfg, scaler)
    sources = log_scale(src_mel).reshape(b, n_src, *src_mel.shape[1:])
    return sources, log_scale(mix_mel)


def make_sepsed_predict_step(mel_cfg: MelConfig = MelConfig(),
                             scaler_cfg: ScalerConfig = ScalerConfig()):
    """Inference forward over separated sources, with the signature of
    `mean_teacher.make_predict_step`'s: predict(model, audio [B, n_src, N],
    embeddings=None, scaler=None, pad_mask=None) -> (strong, weak), in eval
    mode (the module's mode is restored)."""

    @torch.no_grad()
    def predict(model, audio, embeddings=None, scaler=None, pad_mask=None):
        was_training = model.training
        model.eval()
        try:
            return model(*sepsed_featurize(audio, scaler, mel_cfg, scaler_cfg))
        finally:
            model.train(was_training)

    return predict


def make_sepsed_train_step(cfg: MeanTeacherConfig, optimizer: ClipAdam,
                           schedule: ExponentialWarmup, mel_cfg: MelConfig = MelConfig(),
                           scaler_cfg: ScalerConfig = ScalerConfig()):
    """train_step(state, batch, generator) -> metrics (0-d tensors: loss,
    loss_strong, loss_weak, lr, tot_self_loss), updating `state` in place; the
    batch slots' "audio" is [b, n_src, N]."""
    selfsup = SELF_SUP_LOSSES[cfg.self_sup_loss]
    sa, sb = cfg.role_range("strong")
    wa, wb = cfg.role_range("weak")
    ca, cb = cfg.consistency_range

    def train_step(state: MeanTeacherState, batch: dict, generator: torch.Generator):
        student = state.student
        params = list(student.parameters())
        dev = params[0].device
        if generator.device.type != dev.type:
            raise ValueError(f"generator on {generator.device}, state on {dev}")
        step = state.step
        audio, labels, _, _ = _concat_batch(cfg, batch, dev)
        sources, mixture = sepsed_featurize(audio, state.scaler, mel_cfg, scaler_cfg)
        labels_weak = (labels[wa:wb].sum(-1) > 0).float()

        with torch.no_grad():  # teacher: train mode
            t_strong, t_weak = state.teacher(sources, mixture, generator=generator)
        weight = cfg.const_max * schedule.scaling_factor(step)

        student.zero_grad(set_to_none=True)
        s_strong, s_weak = student(sources, mixture, generator=generator)
        loss_strong = bce(s_strong[sa:sb], labels[sa:sb])
        loss_weak = bce(s_weak[wa:wb], labels_weak)
        tot_self = (selfsup(s_strong[ca:cb], t_strong[ca:cb])
                    + selfsup(s_weak[ca:cb], t_weak[ca:cb])) * weight
        total = loss_strong + loss_weak + tot_self
        total.backward()
        optimizer.step(params, [p.grad for p in params], state.opt_state)

        alpha = min(np.float32(1) - np.float32(1) / (np.float32(step + 1) + np.float32(1)),
                    np.float32(cfg.ema_factor))
        with torch.no_grad():
            teacher = list(state.teacher.parameters())
            torch._foreach_mul_(teacher, float(alpha))
            torch._foreach_add_(teacher, torch._foreach_mul(params, float(np.float32(1) - alpha)))
        state.step = step + 1
        # the keys in the order of the JAX step's (jit returns them sorted)
        return {"loss": total.detach(), "loss_strong": loss_strong.detach(),
                "loss_weak": loss_weak.detach(), "lr": schedule(step),
                "tot_self_loss": tot_self.detach()}

    return train_step
