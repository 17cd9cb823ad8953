"""Mean-teacher SED train step (counterpart of desed_task_tpu/training/mean_teacher.py).

One step, as mean_teacher.py:271-447 defines it:

    batch (per-slot audio / labels / embeddings / class masks)
      -> linear mel (ops/frontend) -> optional frame shift and noise
      -> probabilistic within-group mixup of features, embeddings, labels
      -> class-validity label masking -> log-dB
      -> teacher forward (train mode, no_grad; its own BN buffers update)
      -> student forward (train mode: dropout, SpecAugment, dropstep, BN
         batch statistics) -> BCE on the strong and weak slots + MSE/BCE
         consistency with the teacher, weighted by const_max * the
         optimizer's warmup ramp, frozen after `decay_steps`
      -> backward -> clip by global norm + Adam (lr from the schedule at the
         pre-increment step, as optax) -> EMA teacher with
         alpha = min(1 - 1/(step + 2), ema_factor) on the UPDATED student.

On the card the CNN blocks and the BiGRU run through the hand-written
forward and backward kernels (ops/fused_cnn.py, ops/gru.py). PyTorch runs
eagerly, so the step updates the state in place (parameters, optimizer
moments, BN buffers, step counter) instead of returning a new state.

Randomness: every tensor draw comes from the step's `torch.Generator` (on
the state's device). The mixup gate and the Beta(0.2, 0.2) coefficients are
drawn on the host from a numpy Generator seeded with the generator's
initial seed and the step (as JAX folds the step into its key), so the step
never waits for the card to hand over a seed.

Not ported yet (they raise NotImplementedError): `accumulate > 1`, the
`axis_name` / sharded data-parallel step and the in-graph `embedder`.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from ..ops.augment import add_noise, frame_shift, mixup
from ..ops.frontend import MelConfig, amplitude_to_db, mel_spectrogram
from ..ops.scaler import ScalerConfig, ScalerState, apply_scaler
from .losses import SELF_SUP_LOSSES, bce
from .schedulers import ExponentialWarmup


@dataclasses.dataclass(frozen=True)
class SlotSpec:
    """One fixed-ratio batch slot (ConcatDatasetBatchSampler semantics,
    desed_task/dataio/sampler.py:69-79)."""

    name: str
    size: int  # examples per step for this slot
    role: str  # "strong" | "weak" | "unlabeled"


@dataclasses.dataclass(frozen=True)
class MeanTeacherConfig:
    slots: tuple[SlotSpec, ...]
    # mixup
    mixup: Optional[str] = "soft"  # "soft" | "hard" | None
    mixup_prob: float = 0.5
    mixup_groups: tuple[tuple[str, ...], ...] = ()  # groups of slot names
    # consistency
    const_max: float = 2.0
    self_sup_loss: str = "mse"
    consistency_start_slot: int = 0  # slot index from which consistency applies
    rampup_steps: int = 1
    decay_steps: Optional[int] = None  # freeze weight at const_max afterwards
    # teacher
    ema_factor: float = 0.999
    # optional augmentations (off in all reference recipes' steps)
    frame_shift_std: float = 0.0
    add_noise_snrs: Optional[tuple[float, float]] = None
    net_pooling: int = 4
    # 2021-style: weak targets derived before mixup and soft-mixed directly
    weak_labels_post_mixup: bool = True

    def _offsets(self):
        offs = [0]
        for s in self.slots:
            offs.append(offs[-1] + s.size)
        return offs

    @property
    def batch_size(self) -> int:
        return self._offsets()[-1]

    def slot_range(self, name: str) -> tuple[int, int]:
        offs = self._offsets()
        for i, s in enumerate(self.slots):
            if s.name == name:
                return offs[i], offs[i + 1]
        raise KeyError(name)

    def role_range(self, role: str) -> tuple[int, int]:
        """Contiguous range of all slots with `role`."""
        offs = self._offsets()
        idx = [i for i, s in enumerate(self.slots) if s.role == role]
        if not idx:
            return (0, 0)
        if idx != list(range(idx[0], idx[-1] + 1)):
            raise ValueError(f"{role} slots are not contiguous")
        return offs[idx[0]], offs[idx[-1] + 1]

    @property
    def consistency_range(self) -> tuple[int, int]:
        return self._offsets()[self.consistency_start_slot], self.batch_size


@dataclasses.dataclass
class MeanTeacherState:
    """Student and teacher modules (distinct copies), the optimizer's state
    and the number of optimizer steps taken."""

    step: int
    student: nn.Module
    teacher: nn.Module
    opt_state: dict
    scaler: Optional[ScalerState] = None


class ClipAdam:
    """optax.chain(clip_by_global_norm(max_grad_norm), adam(schedule)) on a
    list of tensors, in place, with multi-tensor (`torch._foreach_*`) ops:
    a few launches per step instead of ~20 per parameter tensor.

    Clipping scales by max_norm / ||g|| when ||g|| >= max_norm (optax writes
    g / ||g|| * max_norm: one rounding apart; torch's clip_grad_norm_
    divides by ||g|| + 1e-6 instead). Adam's moments are updated as optax
    does, (1 - b) g + b m; its bias corrections and the schedule are
    float32, and the learning rate is the schedule's at the count before
    the increment.
    """

    def __init__(self, schedule: ExponentialWarmup, max_grad_norm: float = 5.0,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.schedule = schedule
        self.max_grad_norm = max_grad_norm
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params) -> dict:
        return {"count": 0,
                "mu": [torch.zeros_like(p) for p in params],
                "nu": [torch.zeros_like(p) for p in params]}

    @torch.no_grad()
    def step(self, params, grads, state: dict) -> torch.Tensor:
        """Update `params` in place from `grads`; returns the global norm of
        the gradients before clipping."""
        g_norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        if self.max_grad_norm:
            scale = torch.where(g_norm < self.max_grad_norm, torch.ones_like(g_norm),
                                self.max_grad_norm / g_norm)
            grads = torch._foreach_mul(grads, scale)
        mu, nu = state["mu"], state["nu"]
        count = state["count"]
        lr = float(self.schedule(count))
        one = np.float32(1)
        bc1 = float(one - np.float32(self.b1) ** np.float32(count + 1))
        bc2 = float(one - np.float32(self.b2) ** np.float32(count + 1))
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, torch._foreach_mul(grads, 1.0 - self.b1))
        torch._foreach_mul_(nu, self.b2)
        g2 = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(g2, 1.0 - self.b2)
        torch._foreach_add_(nu, g2)
        denom = torch._foreach_sqrt(torch._foreach_div(nu, bc2))
        torch._foreach_add_(denom, self.eps)
        update = torch._foreach_div(torch._foreach_div(mu, bc1), denom)
        torch._foreach_mul_(update, -lr)
        torch._foreach_add_(params, update)
        state["count"] = count + 1
        return g_norm


def make_optimizer(lr: float, rampup_steps: int, max_grad_norm: float = 5.0,
                   start_annealing: int | None = None, max_steps: int | None = None
                   ) -> tuple[ClipAdam, ExponentialWarmup]:
    """Adam + exponential warmup + global-norm clipping, as the reference
    (train_pretrained.py:469-482 and the Trainer's gradient_clip_val)."""
    schedule = ExponentialWarmup(max_lr=lr, rampup_length=rampup_steps,
                                 start_annealing=start_annealing, max_steps=max_steps)
    return ClipAdam(schedule, max_grad_norm), schedule


def create_state(model: nn.Module, cfg: MeanTeacherConfig, optimizer: ClipAdam,
                 device: str | torch.device | None = None,
                 scaler: ScalerState | None = None) -> MeanTeacherState:
    """Student = `model` (moved to `device`, default "cuda"); the teacher
    starts as a distinct copy of it and takes no gradients (the reference
    deepcopies the student, train_pretrained.py:520-533)."""
    del cfg  # the port's modules are shaped at construction
    dev = resolve_device(device)
    student = model.to(dev).train()
    teacher = copy.deepcopy(student).train()
    for p in teacher.parameters():
        p.requires_grad_(False)
    return MeanTeacherState(step=0, student=student, teacher=teacher,
                            opt_state=optimizer.init(list(student.parameters())),
                            scaler=scaler)


def _concat_batch(cfg: MeanTeacherConfig, batch: dict, device: torch.device):
    """Per-slot arrays in slot order -> batch tensors on `device`."""
    as_t = lambda a, dt=None: torch.as_tensor(a, device=device, dtype=dt)
    audio = torch.cat([as_t(batch[s.name]["audio"], torch.float32) for s in cfg.slots])
    labels = torch.cat([as_t(batch[s.name]["labels"], torch.float32) for s in cfg.slots])
    embs = [batch[s.name].get("embeddings") for s in cfg.slots]
    emb = None if embs[0] is None else torch.cat([as_t(e, torch.float32) for e in embs])
    n_class = labels.shape[1]
    masks = []
    for s in cfg.slots:
        m = batch[s.name].get("class_mask")
        if m is None:  # made on the device: no host-to-device copy in the step
            m = torch.ones((len(batch[s.name]["audio"]), n_class), dtype=torch.bool,
                           device=device)
        masks.append(as_t(m, torch.bool))
    return audio, labels, emb, torch.cat(masks)


def make_train_step(cfg: MeanTeacherConfig, optimizer: ClipAdam, schedule: ExponentialWarmup,
                    mel_cfg: MelConfig = MelConfig(), scaler_cfg: ScalerConfig = ScalerConfig(),
                    embedder=None, axis_name: str | None = None, accumulate: int = 1):
    """Build train_step(state, batch, generator) -> metrics, which updates
    `state` in place. `generator` is a torch.Generator on the state's
    device; metrics are 0-d tensors with the keys of mean_teacher.py:439-443."""
    if accumulate != 1:
        raise NotImplementedError("gradient accumulation (accumulate > 1) is not ported yet")
    if axis_name is not None:
        raise NotImplementedError("the sharded data-parallel step is not ported yet")
    if embedder is not None:
        raise NotImplementedError("the in-graph embedder is not ported yet")
    selfsup = SELF_SUP_LOSSES[cfg.self_sup_loss]
    sa, sb = cfg.role_range("strong")
    wa, wb = cfg.role_range("weak")
    ca, cb = cfg.consistency_range

    def detect(model, x, emb, cmask, scaler, generator):
        """scaler + model forward (sed_trainer detect, :274-280)."""
        return model(apply_scaler(x, scaler_cfg, scaler), classes_mask=cmask,
                     embeddings=emb, generator=generator)

    def train_step(state: MeanTeacherState, batch: dict, generator: torch.Generator):
        dev = next(state.student.parameters()).device
        if generator.device.type != dev.type:
            raise ValueError(f"generator on {generator.device}, state on {dev}")
        step = state.step
        host = np.random.default_rng([generator.initial_seed(), step])

        weight = cfg.const_max * schedule.scaling_factor(step)
        if cfg.decay_steps is not None and step >= cfg.decay_steps:
            weight = torch.tensor(cfg.const_max, dtype=torch.float32)

        audio, labels, emb, cmask = _concat_batch(cfg, batch, dev)
        features = mel_spectrogram(audio, mel_cfg)  # linear mel (power=1)
        if cfg.frame_shift_std > 0:
            features, labels = frame_shift(generator, features, labels, cfg.net_pooling,
                                           cfg.frame_shift_std, label_axis=-1)
        if cfg.add_noise_snrs is not None:
            features = add_noise(generator, features, cfg.add_noise_snrs)

        labels_weak_pre = (labels[wa:wb].sum(-1) > 0).float()
        if cfg.mixup is not None and cfg.mixup_groups:
            do_mix = host.random() < cfg.mixup_prob  # one gate per step
            features, labels = features.clone(), labels.clone()
            emb = None if emb is None else emb.clone()
            for group in cfg.mixup_groups:
                a = min(cfg.slot_range(n)[0] for n in group)
                b = max(cfg.slot_range(n)[1] for n in group)
                c = float(host.beta(0.2, 0.2))
                if not do_mix:
                    continue
                perm = torch.randperm(b - a, generator=generator, device=dev)
                features[a:b], labels[a:b], _ = mixup(
                    generator, features[a:b], labels[a:b], mixup_label_type=cfg.mixup,
                    perm=perm, c=c)
                if emb is not None:
                    emb[a:b] = c * emb[a:b] + (1.0 - c) * emb[a:b][perm]
                if not cfg.weak_labels_post_mixup and (a, b) == (wa, wb):
                    lw = labels_weak_pre[perm]
                    if cfg.mixup == "soft":
                        labels_weak_pre = torch.clamp(c * labels_weak_pre + (1 - c) * lw, 0, 1)
                    else:
                        labels_weak_pre = torch.clamp(labels_weak_pre + lw, 0, 1)

        if cfg.weak_labels_post_mixup:
            labels_weak = (labels[wa:wb].sum(-1) > 0).float()
        else:
            labels_weak = labels_weak_pre
        labels = labels.masked_fill(~cmask[:, :, None], 0.0)
        labels_weak = labels_weak.masked_fill(~cmask[wa:wb], 0.0)
        x = amplitude_to_db(features, mel_cfg)

        with torch.no_grad():  # teacher: train mode, its own BN buffers update
            t_strong, t_weak = detect(state.teacher, x, emb, cmask, state.scaler, generator)

        student = state.student
        student.zero_grad(set_to_none=True)
        s_strong, s_weak = detect(student, x, emb, cmask, state.scaler, generator)
        loss_strong = bce(s_strong[sa:sb], labels[sa:sb])
        loss_weak = bce(s_weak[wa:wb], labels_weak)
        strong_self = selfsup(s_strong[ca:cb], t_strong[ca:cb])
        weak_self = selfsup(s_weak[ca:cb], t_weak[ca:cb])
        tot_self = (strong_self + weak_self) * weight
        total = loss_strong + loss_weak + tot_self
        total.backward()

        params = list(student.parameters())
        grad_norm = optimizer.step(params, [p.grad for p in params], state.opt_state)

        # EMA teacher on the UPDATED student (float32, as mean_teacher.py:421-427);
        # BN buffers are not EMA'd
        alpha = min(np.float32(1) - np.float32(1) / (np.float32(step + 1) + np.float32(1)),
                    np.float32(cfg.ema_factor))
        with torch.no_grad():
            teacher = list(state.teacher.parameters())
            torch._foreach_mul_(teacher, float(alpha))
            torch._foreach_add_(teacher, torch._foreach_mul(params, float(np.float32(1) - alpha)))
        state.step = step + 1

        return {
            "loss": total.detach(),
            "loss_strong": loss_strong.detach(),
            "loss_weak": loss_weak.detach(),
            "strong_self_sup_loss": strong_self.detach(),
            "weak_self_sup_loss": weak_self.detach(),
            "tot_self_loss": tot_self.detach(),
            "weight": weight,
            "lr": schedule(step),
            "grad_norm": grad_norm,
        }

    return train_step


def make_predict_step(mel_cfg: MelConfig = MelConfig(), scaler_cfg: ScalerConfig = ScalerConfig()):
    """Inference forward: predict(model, audio, embeddings=None, scaler=None,
    pad_mask=None) -> (strong, weak), in eval mode (no dropout or
    SpecAugment, BN running statistics); the module's mode is restored."""

    @torch.no_grad()
    def predict(model, audio, embeddings=None, scaler=None, pad_mask=None):
        was_training = model.training
        model.eval()
        try:
            feats = amplitude_to_db(mel_spectrogram(audio, mel_cfg), mel_cfg)
            return model(apply_scaler(feats, scaler_cfg, scaler), pad_mask=pad_mask,
                         embeddings=embeddings)
        finally:
            model.train(was_training)

    return predict
