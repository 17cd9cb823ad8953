"""PANNs CNN14-16k embedder (counterpart of desed_task_tpu/models/panns.py).

The frozen CNN14 of the 2022 recipe's PANNs embeddings, in eval mode:

  * the torchlibrosa front-end: power spectrogram (periodic hann 512, hop
    160, centred, reflect), librosa's slaney mel (64 bins, 50-8000 Hz,
    slaney norm), power_to_db (10 log10, amin 1e-10, no clamp): the port's
    ops/frontend with `PANNS_MEL`;
  * bn0, a BatchNorm over the 64 mel bins;
  * 6 blocks of two (3x3 conv without bias, BatchNorm, ReLU) and a 2x2
    average pool (VALID, floored; block 6 does not pool), 64 -> 2048
    channels;
  * "frame": block 3's output [B, 256, T/8, 8] laid out channel-major over
    (channel, frequency), [B, 2048, T/8] (125 frames for 10 s);
    "global": block 6's output, mean over frequency, then max plus mean
    over time, [B, 2048].

Activations run NCHW with H = time and W = mel. The convolutions are
`F.conv2d`, as JAX uses `nn.Conv`; the forward pins fp32
(`device.fp32_math`). Module names follow the flax tree (`conv_block{i}.
conv{j}`, `.bn{j}`, `bn0`), so models/convert.from_jax_embedder_params maps
it leaf by leaf.
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.nn import functional as F

from ..device import fp32_math
from ..ops.frontend import MelConfig, amplitude_to_db, mel_spectrogram

PANNS_MEL = MelConfig(
    sample_rate=16000, n_fft=512, win_length=512, hop_length=160, f_min=50.0, f_max=8000.0,
    n_mels=64, power=2.0, window="hann", periodic_window=True, mel_scale="slaney",
    mel_norm="slaney", amin=1e-10, db_clamp_min=None, db_clamp_max=None)
BN_EPS = 1e-5


class EvalBatchNorm(nn.Module):
    """BatchNorm over dim 1 with its running statistics (eval mode)."""

    def __init__(self, ch: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))
        self.register_buffer("running_mean", torch.zeros(ch))
        self.register_buffer("running_var", torch.ones(ch))

    def forward(self, x):
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                            False, 0.0, BN_EPS)


class ConvBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, pool: bool = True):
        super().__init__()
        self.pool = pool
        self.conv1 = nn.Conv2d(in_ch, out_ch, 3, padding=1, bias=False)
        self.bn1 = EvalBatchNorm(out_ch)
        self.conv2 = nn.Conv2d(out_ch, out_ch, 3, padding=1, bias=False)
        self.bn2 = EvalBatchNorm(out_ch)

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        return F.avg_pool2d(x, 2) if self.pool else x


class Cnn14_16k(nn.Module):
    """waveform [B, N] -> {"global": [B, 2048], "frame": [B, 2048, T/8]}."""

    CHANNELS = (64, 128, 256, 512, 1024, 2048)

    def __init__(self):
        super().__init__()
        self.bn0 = EvalBatchNorm(PANNS_MEL.n_mels)
        ins = (1,) + self.CHANNELS[:-1]
        for i, (ci, co) in enumerate(zip(ins, self.CHANNELS), start=1):
            self.add_module(f"conv_block{i}", ConvBlock(ci, co, pool=i < 6))

    def forward(self, audio):
        with fp32_math():
            logmel = amplitude_to_db(mel_spectrogram(audio, PANNS_MEL), PANNS_MEL)  # [B, 64, T]
            x = self.bn0(logmel).transpose(1, 2)[:, None]  # [B, 1, T, 64]
            frame = None
            for i in range(1, 7):
                x = getattr(self, f"conv_block{i}")(x)
                if i == 3:
                    frame = x  # [B, 256, T/8, 8]
            x = x.mean(dim=3)  # over frequency: [B, 2048, T']
            global_emb = x.amax(dim=2) + x.mean(dim=2)
            b, ch, t8, f8 = frame.shape
            frame = frame.transpose(2, 3).reshape(b, ch * f8, t8)
            return {"global": global_emb, "frame": frame}


@torch.no_grad()
def init_panns(model: Cnn14_16k, generator: torch.Generator) -> Cnn14_16k:
    """Seeded random weights from `generator` (CPU), in the order of
    `named_parameters`: conv weights normal with std sqrt(2 / fan_in) (He,
    for the ReLUs), BatchNorm scale 1 and bias 0; running mean 0 and
    variance 1."""
    for name, p in model.named_parameters():
        if p.dim() == 4:
            fan_in = p[0].numel()
            p.copy_(torch.randn(p.shape, generator=generator) * math.sqrt(2.0 / fan_in))
        else:
            p.fill_(1.0 if name.endswith("weight") else 0.0)
    return model
