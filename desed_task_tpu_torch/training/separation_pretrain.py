"""MixIT pretraining of the TDCN++ separator on unlabeled audio
(counterpart of desed_task_tpu/training/separation_pretrain.py).

Unsupervised mixture-invariant training (training/mixit.py) of
models/tdcn.py on any folder of unlabeled wavs, validated by SI-SNRi on
two-source mixtures built from held-out clips (metrics/separation.py).
Clips are cropped on the host to one fixed segment length with the JAX
package's numpy draws, so a seed gives the same segments on both.

A step updates the model and the optimizer's state in place: mixtures of
mixtures, the 2^M assignment search, the gradients, clipping by global norm
and Adam at a fixed learning rate. The best epoch's weights (by SI-SNRi)
are saved with their model configuration in a torch file that
tools/separation.py `TorchSeparationModel` loads.
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path
from typing import Sequence

import numpy as np
import torch

from ..data.audio_io import read_audio
from ..device import fp32_math, resolve_device
from ..metrics.separation import si_snr_improvement
from ..models.tdcn import TDCNPP, init_tdcn
from ..obs.logging import MetricsLogger
from .mean_teacher import ClipAdam
from .mixit import mixit_loss, mixture_of_mixtures


@dataclasses.dataclass(frozen=True)
class MixITPretrainConfig:
    n_src: int = 4
    segment_len: int = 64000      # 4 s at 16 kHz
    batch_mixtures: int = 16      # per step, paired into batch_mixtures // 2 MoMs
    lr: float = 1e-3
    grad_clip: float = 5.0
    snr_max: float = 30.0
    steps_per_epoch: int = 100
    n_epochs: int = 10
    val_pairs: int = 32           # synthetic eval mixtures per validation
    seed: int = 0


class _SegmentPool:
    """Host-side pool of fixed-length segments cropped from wav folders.

    Clips shorter than segment_len are tiled; longer ones yield random
    crops. The clips are decoded once, at construction, and resampled to
    `fs` where they are at another rate."""

    def __init__(self, folders: Sequence[str | Path], segment_len: int, fs: int = 16000,
                 limit: int | None = None):
        self.segment_len = segment_len
        self.clips: list[np.ndarray] = []
        for folder in folders:
            wavs = sorted(Path(folder).glob("*.wav"))
            if limit is not None:
                wavs = wavs[: max(limit - len(self.clips), 0)]
            for w in wavs:
                audio, *_ = read_audio(w, target_fs=fs)
                if audio.shape[-1] < segment_len:
                    audio = np.tile(audio, -(-segment_len // audio.shape[-1]))
                self.clips.append(audio.astype(np.float32))
        if not self.clips:
            raise FileNotFoundError(f"no wavs under {list(folders)}")

    def sample(self, n: int, rng: np.random.Generator) -> np.ndarray:
        """[n, segment_len] random crops from random clips."""
        out = np.empty((n, self.segment_len), np.float32)
        idx = rng.integers(0, len(self.clips), n)
        for row, i in enumerate(idx):
            clip = self.clips[i]
            start = rng.integers(0, clip.shape[-1] - self.segment_len + 1)
            out[row] = clip[start : start + self.segment_len]
        return out

    def fixed_pairs(self, n_pairs: int, seed: int) -> np.ndarray:
        """[n_pairs, 2, segment_len] deterministic source pairs for eval."""
        rng = np.random.default_rng(seed)
        return self.sample(2 * n_pairs, rng).reshape(n_pairs, 2, -1)


def make_optimizer(cfg: MixITPretrainConfig) -> ClipAdam:
    """clip_by_global_norm(grad_clip) + Adam at the fixed cfg.lr."""
    return ClipAdam(lambda count: cfg.lr, cfg.grad_clip)


def make_mixit_train_step(cfg: MixITPretrainConfig, optimizer: ClipAdam):
    """step(model, opt_state, audio [2B, N]) -> {"loss", "grad_norm"} (0-d
    tensors; grad_norm before clipping), updating the model and opt_state
    in place."""

    def step(model: TDCNPP, opt_state: dict, audio: torch.Tensor) -> dict:
        moms, pairs = mixture_of_mixtures(audio)
        model.zero_grad(set_to_none=True)
        with fp32_math():
            loss, _ = mixit_loss(model(moms), pairs, cfg.snr_max)
            loss.backward()
        params = list(model.parameters())
        # the last block's residual output feeds nothing: its 1x1 conv and
        # scale get no gradient (zeros, as jax.grad gives them)
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
        gnorm = optimizer.step(params, grads, opt_state)
        return {"loss": loss.detach(), "grad_norm": gnorm}

    return step


@torch.no_grad()
def eval_step(model: TDCNPP, sources: torch.Tensor) -> torch.Tensor:
    """sources [B, 2, N] -> the mean SI-SNRi of the separated mixtures."""
    mixture = sources.sum(1)
    return si_snr_improvement(sources, model(mixture), mixture).mean()


def pretrain_separator(
    train_folders: Sequence[str | Path],
    val_folders: Sequence[str | Path],
    log_dir: str | Path,
    cfg: MixITPretrainConfig = MixITPretrainConfig(),
    model_kwargs: dict | None = None,
    limit_clips: int | None = None,
    device: str | torch.device | None = None,
) -> tuple[TDCNPP, Path]:
    """Run MixIT pretraining on `device` (default "cuda"); returns (the
    final model, the best checkpoint's path, log_dir/tdcn_mixit_best.pt)."""
    device = resolve_device(device)
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    config = dict(n_src=cfg.n_src, **(model_kwargs or {}))
    model = init_tdcn(TDCNPP(**config), torch.Generator().manual_seed(cfg.seed)).to(device)
    rng = np.random.default_rng(cfg.seed)

    pool = _SegmentPool(train_folders, cfg.segment_len, limit=limit_clips)
    val_pool = _SegmentPool(val_folders, cfg.segment_len, limit=limit_clips)
    val_sources = torch.as_tensor(val_pool.fixed_pairs(cfg.val_pairs, cfg.seed), device=device)

    tx = make_optimizer(cfg)
    opt_state = tx.init(list(model.parameters()))
    train_step = make_mixit_train_step(cfg, tx)

    logger = MetricsLogger(log_dir)
    logger.log_hparams(dataclasses.asdict(cfg))
    best_path = log_dir / "tdcn_mixit_best.pt"
    best_si_snri = -np.inf
    step_no = 0
    for epoch in range(cfg.n_epochs):
        t0 = time.time()
        for _ in range(cfg.steps_per_epoch):
            audio = torch.as_tensor(pool.sample(cfg.batch_mixtures, rng), device=device)
            metrics = train_step(model, opt_state, audio)
            step_no += 1
        loss = float(metrics["loss"])
        si_snri = float(eval_step(model, val_sources))
        logger.log_scalars(step_no, {
            "train/mixit_loss": loss,
            "val/si_snri_db": si_snri,
            "train/epoch_seconds": time.time() - t0,
        })
        print(f"[mixit] epoch {epoch}: loss={loss:.3f} val SI-SNRi={si_snri:.2f} dB",
              flush=True)
        if si_snri > best_si_snri:
            best_si_snri = si_snri
            torch.save({"config": config,
                        "state_dict": {k: v.detach().cpu() for k, v in model.state_dict().items()}},
                       best_path)
    logger.close()
    return model, best_path
