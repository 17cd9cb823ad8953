#!/usr/bin/env python3
"""How far the port's CPU log-mel lands from float64 when one GEMM's operands
are rounded to TF32 (CPU only; no card needed).

    python3 scripts/precision_log_mel.py [--seed 0] [--batch 2] [--samples 16000]

The reference is the GEMM front-end's log-mel (`MelConfig()`, power 1) in
float64 from the same fp32 constants, as `tests/test_torch_frontend.py`
`_log_mel_f64` computes it, on the same audio as `test_log_mel_matches_jax`
(numpy seed 0, 2 x 16000 samples x 0.1). Each variant computes the DFT GEMM
(frames x basis) and the mel GEMM (magnitude x filterbank) as fp32 products
of its operands, rounded first to TF32 (10 mantissa bits, to nearest, ties
to even) where the variant says so, and prints its max |dB - float64| in dB:

    fp32         both GEMMs in fp32 (the port's `log_mel_spectrogram`)
    tf32 mel     the mel GEMM's operands in TF32, the DFT in fp32
    tf32 dft     the DFT GEMM's operands in TF32, the mel GEMM in fp32
    tf32 both    both GEMMs' operands in TF32
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from desed_task_tpu_torch.ops import frontend as tfe  # noqa: E402


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> the nearest TF32 value (ties to even), kept in fp32."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0xFFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


def log_mel(audio: torch.Tensor, cfg: tfe.MelConfig, tf32_dft: bool, tf32_mel: bool):
    basis, fb = tfe._constants(cfg, torch.device("cpu"), torch.float32)
    frames = tfe.frame_signal(audio, cfg)
    r = to_tf32 if tf32_dft else (lambda t: t)
    with tfe.fp32_products(audio.device):
        reim = torch.matmul(r(frames), r(basis))
    n = cfg.n_freqs
    re, im = reim[..., :n], reim[..., n:]
    mag = torch.sqrt(torch.clamp(re * re + im * im, min=0.0))
    r = to_tf32 if tf32_mel else (lambda t: t)
    with tfe.fp32_products(audio.device):
        mel = torch.matmul(r(mag), r(fb))
    return tfe.amplitude_to_db(mel.transpose(-1, -2), cfg)


def log_mel_f64(audio: np.ndarray, cfg: tfe.MelConfig) -> np.ndarray:
    basis, fb = (c.double().numpy() for c in tfe._constants(cfg, torch.device("cpu"),
                                                             torch.float32))
    reim = tfe.frame_signal(torch.from_numpy(audio).double(), cfg).numpy() @ basis
    re, im = reim[..., : cfg.n_freqs], reim[..., cfg.n_freqs:]
    mel = np.swapaxes(np.sqrt(re * re + im * im) @ fb, -1, -2)
    db = 20.0 * np.log10(np.maximum(mel, cfg.amin))
    return np.clip(db, cfg.db_clamp_min, cfg.db_clamp_max)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--samples", type=int, default=16000)
    args = ap.parse_args()
    audio = (np.random.default_rng(args.seed).standard_normal((args.batch, args.samples))
             * 0.1).astype(np.float32)
    cfg = tfe.MelConfig()
    want = log_mel_f64(audio, cfg)
    x = torch.from_numpy(audio)
    port = tfe.log_mel_spectrogram(x, cfg).numpy()
    print(f"fp32 (log_mel_spectrogram): {np.abs(port - want).max():.3e} dB")
    for name, dft, mel in (("fp32", False, False), ("tf32 mel", False, True),
                           ("tf32 dft", True, False), ("tf32 both", True, True)):
        got = log_mel(x, cfg, dft, mel).numpy()
        print(f"{name}: {np.abs(got - want).max():.3e} dB")
    return 0


if __name__ == "__main__":
    sys.exit(main())
