"""Plain reference of the mean-teacher train step and of the eval forward.

The step, as the DCASE 2024 baseline's `sed_trainer_pretrained.py` trains
(and the 2023 one, with its three slots):

    audio -> linear mel -> within-group mixup (one gate a step, one
    Beta(0.2, 0.2) coefficient a group) -> class-validity masking of the
    labels -> dB -> instance min-max -> teacher forward (train mode, no
    gradient) -> student forward -> BCE on the strong and weak slots + MSE
    consistency with the teacher, weighted by const_max times the warmup
    ramp -> backward -> clip by global norm 5 -> Adam (optax's moment
    updates, float32 bias corrections, the learning rate of the step
    before the increment) -> EMA teacher, alpha = min(1 - 1 / (step + 2),
    0.999), on the updated student.

The mixup gate and coefficients come from numpy's default_rng([seed,
step]), the permutations and every mask from the step's torch.Generator
seeded with `seed`: the draws of the framework's documented step. It
imports nothing of the program under test.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .model import crnn_forward, exact, is_statistic, mel_magnitude, median_filter, \
    minmax_scale, to_db


def warmup(step: int, max_value: float, rampup: int) -> float:
    """exp(-5 (1 - min(step, L) / L)^2) * max_value, in float32."""
    if rampup == 0:
        return float(np.float32(max_value))
    phase = np.float32(1.0) - np.float32(min(step, rampup)) / np.float32(rampup)
    return float(np.float32(max_value) * np.exp(np.float32(-5.0) * phase * phase))


def bce(p, t):
    p, t = p.float(), t.float()
    return -(t * torch.clamp(torch.log(p), min=-100.0)
             + (1.0 - t) * torch.clamp(torch.log(1.0 - p), min=-100.0)).mean()


def mse(a, b):
    return ((a.float() - b.float()) ** 2).mean()


def slot_ranges(slots: list[dict]):
    """(strong, weak, consistency) row ranges of the concatenated slots; the
    consistency loss leaves out a leading maestro slot."""
    offs = np.cumsum([0] + [s["size"] for s in slots])

    def rng(role):
        idx = [i for i, s in enumerate(slots) if s["role"] == role]
        return (int(offs[idx[0]]), int(offs[idx[-1] + 1])) if idx else (0, 0)

    start = 1 if slots[0]["name"] == "maestro" else 0
    return rng("strong"), rng("weak"), (int(offs[start]), int(offs[-1]))


def mixup_groups(slots: list[dict]) -> list[tuple[int, int]]:
    """Row ranges mixed together: the weak slot, the synthetic and strong
    slots, the maestro slot (sed_trainer_pretrained.py's mixup)."""
    offs = dict()
    o = 0
    for s in slots:
        offs[s["name"]] = (o, o + s["size"])
        o += s["size"]
    groups = []
    for names in (("weak",), ("synth", "strong"), ("maestro",)):
        present = [offs[n] for n in names if n in offs]
        if present:
            groups.append((min(a for a, _ in present), max(b for _, b in present)))
    return groups


class MeanTeacherReference:
    """Student, teacher and Adam state as float32 dicts; `step(batch)` takes
    one step and returns its losses."""

    def __init__(self, params: dict, config: dict, seed: int, device, q=exact):
        self.cfg = config
        self.net = config["net"]
        self.q = q
        self.student = {k: v.detach().clone().float().requires_grad_(not is_statistic(k))
                        for k, v in params.items()}
        self.teacher = {k: v.detach().clone().float() for k, v in params.items()}
        self.trained = [k for k in params if not is_statistic(k)]
        self.mu = {k: torch.zeros_like(self.student[k]) for k in self.trained}
        self.nu = {k: torch.zeros_like(self.student[k]) for k in self.trained}
        self.count = 0
        self.seed = int(seed)
        self.gen = torch.Generator(device=device).manual_seed(self.seed)
        t = config["training"]
        self.rampup = t["n_epochs_warmup"] * config["steps_per_epoch"]
        self.grad_norms: list[dict] = []  # each step's gradient, per leaf, before clipping
        self.first_scores = None  # the student's frame scores of the first step

    def step(self, batch: dict) -> dict:
        """batch: audio [B, N] float, labels [B, C, T'], embeddings [B, E, Te]
        or None, class_mask [B, C] bool, in slot order."""
        cfg, t = self.cfg, self.cfg["training"]
        slots = cfg["slots"]
        (sa, sb), (wa, wb), (ca, cb) = slot_ranges(slots)
        step = self.count
        host = np.random.default_rng([self.seed, step])
        feats = mel_magnitude(batch["audio"], cfg["feats"], self.q)
        labels = batch["labels"].float()
        emb = batch["embeddings"]
        emb = None if emb is None else emb.float()
        cmask = batch["class_mask"]
        if t.get("mixup"):
            do_mix = host.random() < t.get("mixup_prob", 0.5)
            feats, labels = feats.clone(), labels.clone()
            emb = None if emb is None else emb.clone()
            for a, b in mixup_groups(slots):
                c = float(host.beta(0.2, 0.2))
                if not do_mix:
                    continue
                perm = torch.randperm(b - a, generator=self.gen, device=feats.device)
                feats[a:b] = c * feats[a:b] + (1.0 - c) * feats[a:b][perm]
                labels[a:b] = torch.clamp(c * labels[a:b] + (1.0 - c) * labels[a:b][perm],
                                          0.0, 1.0)
                if emb is not None:
                    emb[a:b] = c * emb[a:b] + (1.0 - c) * emb[a:b][perm]
        weak_labels = (labels[wa:wb].sum(-1) > 0).float()
        labels = labels.masked_fill(~cmask[:, :, None], 0.0)
        weak_labels = weak_labels.masked_fill(~cmask[wa:wb], 0.0)
        x = minmax_scale(to_db(feats))
        with torch.no_grad():
            t_strong, t_weak = crnn_forward(self.teacher, self.net, x, emb, cmask, True,
                                            self.gen, self.q)
        s_strong, s_weak = crnn_forward(self.student, self.net, x, emb, cmask, True,
                                        self.gen, self.q)
        if self.first_scores is None:
            self.first_scores = s_strong.detach().float().cpu()
        weight = warmup(step, t.get("const_max", 2.0), self.rampup)
        loss_strong = bce(s_strong[sa:sb], labels[sa:sb])
        loss_weak = bce(s_weak[wa:wb], weak_labels)
        self_sup = (mse(s_strong[ca:cb], t_strong[ca:cb]) + mse(s_weak[ca:cb], t_weak[ca:cb]))
        total = loss_strong + loss_weak + self_sup * weight
        grads = torch.autograd.grad(total, [self.student[k] for k in self.trained])
        self._adam(dict(zip(self.trained, grads)), step)
        with torch.no_grad():
            alpha = min(np.float32(1) - np.float32(1) / (np.float32(step + 1) + np.float32(1)),
                        np.float32(t.get("ema_factor", 0.999)))
            for k in self.trained:
                self.teacher[k].mul_(float(alpha)).add_(
                    self.student[k].detach() * float(np.float32(1) - alpha))
        return {k: float(v.detach()) for k, v in (("loss", total), ("loss_strong", loss_strong),
                                                  ("loss_weak", loss_weak),
                                                  ("self_sup", self_sup))}

    @torch.no_grad()
    def _adam(self, grads: dict, step: int):
        t = self.cfg["training"]
        self.grad_norms.append(leaf_norms(grads))
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values())).float()
        clip = t.get("gradient_clip", 5.0)
        scale = 1.0 if float(norm) < clip else clip / float(norm)
        grads = {k: g * scale for k, g in grads.items()}
        lr = warmup(step, self.cfg["opt"]["lr"], self.rampup)
        b1, b2, eps = 0.9, 0.999, 1e-8
        bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(step + 1))
        bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(step + 1))
        for k, g in grads.items():
            self.mu[k].mul_(b1).add_(g * (1.0 - b1))
            self.nu[k].mul_(b2).add_(g * g * (1.0 - b2))
            upd = (self.mu[k] / bc1) / (torch.sqrt(self.nu[k] / bc2) + eps)
            self.student[k].add_(upd * -lr)
        self.count = step + 1


def eval_forward(params: dict, config: dict, audio, emb, cmask, q=exact):
    """The eval forward of a batch: (median-filtered strong [B, C, T'], weak)."""
    x = minmax_scale(to_db(mel_magnitude(audio, config["feats"], q)))
    strong, weak = crnn_forward(params, config["net"], x, emb, cmask, False, None, q)
    return median_filter(strong, median_windows(config)), weak


def median_windows(config: dict) -> list[int]:
    m = config["net"].get("median_filter", 7)
    return [int(m)] * config["net"]["nclass"] if isinstance(m, int) else [int(k) for k in m]


def leaf_norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tensors.items()}


def leaf_gaps(prog: dict, ref: dict, keep=None) -> dict:
    """{leaf: |prog - ref| / max(ref, the median leaf's ref)}: the gap
    between the two sides' norms of each leaf (NaN stays NaN)."""
    names = [k for k in ref if keep is None or k in keep]
    med = float(np.median([ref[k] for k in names])) if names else 0.0
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in names}


def worst_leaf_gap(prog: dict, ref: dict, keep=None) -> tuple[float, str]:
    """The largest of `leaf_gaps` and its leaf; NaN wins."""
    worst, at = 0.0, ""
    for k, gap in leaf_gaps(prog, ref, keep).items():
        if gap > worst or math.isnan(gap):
            worst, at = gap, k
    return worst, at
