"""SED inference pipeline (counterpart of desed_task_tpu/inference/pipeline.py).

wav decode on host threads, overlapping the device; on the device the log-mel
front-end, the scaler, the CRNN eval forward, the class-wise median filter
and the full threshold sweep; only the boolean activity tensor and the
scores cross to the host, where events are run-length extracted. Batches
have a static size: the final partial batch is zero-padded.

Events are returned without pandas (the machine with the card has none):
`events` maps each threshold to rows of (event_label, onset, offset,
filename), the columns of the JAX pipeline's DataFrames in the same order.
`events_to_dataframes` turns them into DataFrames where pandas is installed.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from ..data.audio_io import read_audio
from ..device import resolve_device
from ..labels.encoder import ManyHotEncoder
from ..labels.events import find_contiguous_regions
from ..ops.frontend import MelConfig, log_mel_spectrogram
from ..ops.median import classwise_median_filter
from ..ops.scaler import ScalerConfig, apply_scaler
from ..utils.table import EVENT_COLUMNS


class InferencePipeline:
    """Files -> (scores, weak, events).

    model: a CRNN (moved to `device` and put in eval mode); variables: an
    optional state_dict loaded into it; embedder: an optional callable
    audio [B, N] -> frame embeddings [B, E, T_e] run on the device when no
    precomputed embeddings are given (a BEATs model through
    tools/embeddings.frame_embedder). `device` defaults to "cuda".
    """

    def __init__(
        self,
        model: torch.nn.Module,
        variables: dict | None,
        encoder: ManyHotEncoder,
        mel_cfg: MelConfig = MelConfig(),
        scaler_cfg: ScalerConfig = ScalerConfig(),
        scaler_state=None,
        median_filter=None,
        thresholds=(0.5,),
        batch_size: int = 64,
        embedder=None,
        num_workers: int = 8,
        device: str | torch.device | None = None,
    ):
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # the front-end and heads are fp32 products (frontend.py:298-308)
            torch.backends.cuda.matmul.allow_tf32 = False
        if variables is not None:
            model.load_state_dict(variables, strict=True)
        self.model = model.to(self.device).eval()
        self.encoder = encoder
        self.mel_cfg = mel_cfg
        self.scaler_cfg = scaler_cfg
        self.scaler_state = scaler_state
        self.median = (
            tuple(int(m) for m in median_filter) if median_filter is not None else None
        )
        self.thresholds = tuple(float(t) for t in thresholds)
        self._th = torch.tensor(self.thresholds, dtype=torch.float32, device=self.device)
        self.batch_size = batch_size
        self.embedder = embedder
        self.num_workers = num_workers
        self.pad_to = int(encoder.audio_len * encoder.fs)

    @torch.inference_mode()
    def forward(self, audio: torch.Tensor, embeddings: torch.Tensor | None = None):
        """Device program: audio [B, N] -> (strong [B, C, T'], weak [B, C],
        activity [n_th, B, C, T'] bool)."""
        return self._forward_impl(audio, embeddings)

    def _forward_impl(self, audio, embeddings=None):
        """The forward without its inference mode, which tools/export.py
        traces (under no_grad)."""
        x = log_mel_spectrogram(audio, self.mel_cfg)
        x = apply_scaler(x, self.scaler_cfg, self.scaler_state)
        if embeddings is None and self.embedder is not None:
            embeddings = self.embedder(audio)
        strong, weak = self.model(x, embeddings=embeddings)
        if self.median is not None:
            strong = classwise_median_filter(strong, self.median, class_axis=-2, time_axis=-1)
        activity = strong[None] > self._th[:, None, None, None]
        return strong, weak, activity

    def _load_batch(self, paths):
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            rows = list(pool.map(
                lambda p: read_audio(p, pad_to=self.pad_to, test=True)[0], paths))
        return np.stack(rows)

    def run(self, wav_files, embeddings_lookup=None):
        """Process files -> (scores {stem: [C, T']}, weak {stem: [C]},
        events {threshold: [(event_label, onset, offset, filename), ...]}).

        embeddings_lookup: optional callable(stems) -> np [b, E, T_e] for
        precomputed-embedding models.
        """
        wav_files = [str(p) for p in wav_files]
        rows_per_th: dict[float, list] = {t: [] for t in self.thresholds}
        scores, weak_out = {}, {}
        B = self.batch_size
        # decode batch k+1 on host threads while batch k computes on device
        with ThreadPoolExecutor(max_workers=1) as loader:
            future = loader.submit(self._load_batch, wav_files[:B])
            for start in range(0, len(wav_files), B):
                chunk = wav_files[start : start + B]
                audio = future.result()
                if start + B < len(wav_files):
                    future = loader.submit(self._load_batch, wav_files[start + B : start + 2 * B])
                if len(chunk) < B:  # pad the final batch to the static shape
                    audio = np.concatenate(
                        [audio, np.zeros((B - len(chunk), self.pad_to), np.float32)])
                emb = None
                if embeddings_lookup is not None:
                    e = np.asarray(embeddings_lookup([Path(p).stem for p in chunk]))
                    if len(chunk) < B:
                        e = np.concatenate([e, np.zeros((B - len(chunk), *e.shape[1:]), e.dtype)])
                    emb = torch.as_tensor(e, device=self.device)
                strong, weak, activity = self.forward(
                    torch.as_tensor(audio, device=self.device), emb)
                act = activity[:, : len(chunk)].cpu().numpy()  # [n_th, b, C, T']
                strong_np = strong[: len(chunk)].cpu().numpy()
                weak_np = weak[: len(chunk)].cpu().numpy()
                for j, path in enumerate(chunk):
                    stem = Path(path).stem
                    scores[stem] = strong_np[j]
                    weak_out[stem] = weak_np[j]
                    for ti, th in enumerate(self.thresholds):
                        for c in range(act.shape[2]):
                            for a, b in find_contiguous_regions(act[ti, j, c]):
                                rows_per_th[th].append((
                                    self.encoder.labels[c],
                                    float(self.encoder._frame_to_time(a)),
                                    float(self.encoder._frame_to_time(b)),
                                    stem + ".wav",
                                ))
        return scores, weak_out, rows_per_th


def events_to_dataframes(events: dict) -> dict:
    """{threshold: rows} -> {threshold: pandas.DataFrame} (needs pandas)."""
    import pandas as pd

    return {th: pd.DataFrame(rows, columns=list(EVENT_COLUMNS)) for th, rows in events.items()}
