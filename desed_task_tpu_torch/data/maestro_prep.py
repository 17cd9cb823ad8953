"""MAESTRO long-form preparation: sliding-window chunking of minutes-long
recordings into 10 s clips with annotation re-clipping.

Re-designs the reference dprep pipeline
(recipes/dcase2024_task4_baseline/dprep/download_prep_maestro.py:60-131):
windows of `window_len` seconds with `hop_len` 1 s (train) / 5 s (val),
chunk filenames `{stem}-{onset_cs:06d}-{offset_cs:06d}` (centiseconds) so the
overlap-add evaluation (inference/maestro.py) can reassemble file timelines.
No intervaltree dependency — a sorted overlap scan is plenty at this scale.

Own copy of desed_task_tpu/data/maestro_prep.py: the annotations are read
with csv and the tables are column tables (utils/table.py), not DataFrames.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def get_chunk_indices(n_samples: int, window: int, hop: int):
    """Start/end sample pairs; matches the reference chunker: windows slide
    by hop, the final partial window is emitted once if anything remains."""
    out = []
    start = 0
    while start + window <= n_samples:
        out.append((start, start + window))
        start += hop
    if start < n_samples and (not out or out[-1][1] < n_samples):
        out.append((start, n_samples))
    return out


def clip_annotation(events, start_s: float, end_s: float):
    """Events overlapping [start, end) shifted to window-relative time."""
    clipped = []
    for ev in events:
        if ev["offset"] > start_s and ev["onset"] < end_s:
            clipped.append(
                {
                    "onset": max(0.0, ev["onset"] - start_s),
                    "offset": min(end_s - start_s, ev["offset"] - start_s),
                    "event_label": ev["event_label"],
                    "confidence": ev.get("confidence", 1.0),
                }
            )
    return sorted(clipped, key=lambda e: e["onset"])


def read_maestro_annotation(path) -> list[dict]:
    """MAESTRO .txt annotation: onset<TAB>offset<TAB>label<TAB>confidence."""
    import csv

    with open(path, newline="") as f:
        lines = [r for r in csv.reader(f, delimiter="\t") if r]
    width = max((len(r) for r in lines), default=0)
    return [
        {
            "onset": float(r[0]),
            "offset": float(r[1]),
            "event_label": str(r[2]),
            # a short row's missing field is NaN, as read_csv fills it
            "confidence": (float(r[3]) if len(r) > 3 and r[3] != "" else np.nan)
            if width > 3 else 1.0,
        }
        for r in lines
    ]


def split_long_file(
    audio: np.ndarray,
    fs: int,
    events: list[dict],
    stem: str,
    window_len: float = 10.0,
    hop_len: float = 1.0,
):
    """Yield (chunk_name, chunk_audio, chunk_events) windows."""
    for st, end in get_chunk_indices(
        len(audio), int(window_len * fs), int(hop_len * fs)
    ):
        start_cs = int(st / fs * 100)
        end_cs = int(end / fs * 100)
        name = f"{stem}-{start_cs:06d}-{end_cs:06d}"
        yield name, audio[st:end], clip_annotation(events, st / fs, end / fs)


def prepare_maestro_folder(
    audio_files: list,
    annotation_files: list,
    out_audio_folder,
    window_len: float = 10.0,
    hop_len: float = 1.0,
    target_fs: int = 16000,
) -> dict:
    """Chunk a list of long-form files; returns the combined annotation
    table (columns filename, onset, offset, event_label, confidence)."""
    from .audio_io import read_wav, resample, to_mono, write_wav

    out_audio_folder = Path(out_audio_folder)
    out_audio_folder.mkdir(parents=True, exist_ok=True)
    ann_by_stem = {Path(a).stem: a for a in annotation_files}
    rows = []
    for af in audio_files:
        stem = Path(af).stem
        audio, fs = read_wav(af)
        audio = to_mono(audio)
        if fs != target_fs:
            audio = resample(audio, fs, target_fs)
            fs = target_fs
        events = (
            read_maestro_annotation(ann_by_stem[stem]) if stem in ann_by_stem else []
        )
        for name, chunk, chunk_events in split_long_file(
            audio, fs, events, stem, window_len, hop_len
        ):
            write_wav(out_audio_folder / f"{name}.wav", chunk, fs)
            for ev in chunk_events:
                rows.append(
                    {
                        "filename": f"{name}.wav",
                        "onset": ev["onset"],
                        "offset": ev["offset"],
                        "event_label": ev["event_label"],
                        "confidence": ev["confidence"],
                    }
                )
    return {c: np.asarray([r[c] for r in rows], dtype=object if c in ("filename", "event_label")
                          else np.float64)
            for c in ("filename", "onset", "offset", "event_label", "confidence")}


def split_maestro_dev(maestro_files: list, scenes: list[str], split: float = 0.9, seed: int = 42):
    """Seeded per-scene file-level train/val split (train_pretrained.py:97-154)."""
    rng = np.random.RandomState(seed)
    train, val = [], []
    for scene in sorted(set(scenes)):
        scene_files = sorted(f for f, s in zip(maestro_files, scenes) if s == scene)
        perm = rng.permutation(len(scene_files))
        n_train = int(len(scene_files) * split)
        train.extend(scene_files[i] for i in perm[:n_train])
        val.extend(scene_files[i] for i in perm[n_train:])
    return train, val
