"""Synthetic soundscape generation (scaper-equivalent, host-side; own copy
of desed_task_tpu/tools/soundscapes.py, with the tables written without
pandas).

Re-designs the reference's scaper-based DESED synthesis
(recipes/dcase2021_task4_baseline/generate_dcase_task4_2021.py:275-600):
foreground events from a class-organized soundbank are placed over
backgrounds with truncated-normal event counts, uniform onsets, uniform
SNR in [6, 30] dB against a reference level, uniform ±3-semitone pitch
shifts (phase vocoder, tools/dsp.py), LUFS-based loudness (BS.1770), then
the mixture is peak-protected and strong labels are emitted as a
DESED-style tsv.

Generation is split into SAMPLE -> METADATA -> RENDER: every random choice
is recorded in a jams-equivalent per-soundscape JSON (source paths,
segment crops, SNRs, pitch, onset), and `render` is a deterministic
function of that metadata. Subsets are therefore RE-RENDERED from stored
metadata with modified parameters — identical event tables, only gains
changed — exactly like the reference's scaper.generate_from_jams flow
(generate_dcase_subset.py:137-414).

The random draws are the JAX generator's, in its order, from one
np.random.default_rng(seed): the same seed gives the same metadata and the
same samples. `generate` and `rerender_subset` return the event table as a
column table (utils/table.py), one row with missing label and times for a
soundscape without events, and write it as a tsv.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np

from ..utils import table as tbl


@dataclasses.dataclass
class SoundscapeConfig:
    duration: float = 10.0
    fs: int = 16000
    ref_db: float = -50.0  # reference loudness (LUFS)
    snr_range: tuple[float, float] = (6.0, 30.0)
    event_count_mean: float = 3.0
    event_count_std: float = 2.0
    max_events: int = 5
    min_event_dur: float = 0.25
    pitch_range: tuple[float, float] = (-3.0, 3.0)  # semitones, 0,0 = off
    loudness: str = "lufs"  # "lufs" (BS.1770) | "rms"


def _rms_db(x: np.ndarray) -> float:
    rms = np.sqrt(np.mean(np.square(x)) + 1e-12)
    return 20.0 * np.log10(rms + 1e-12)


def _scale_to_db(x: np.ndarray, target_db: float) -> np.ndarray:
    gain = 10.0 ** ((target_db - _rms_db(x)) / 20.0)
    return x * gain


TSV_COLUMNS = ("filename", "onset", "offset", "event_label")


def _write_events(rows: list[dict], out_tsv) -> dict:
    """Event rows -> a column table (float64 times, object names), written
    to out_tsv."""
    table = {c: np.asarray([r[c] for r in rows],
                           dtype=np.float64 if c in ("onset", "offset") else object)
             for c in TSV_COLUMNS}
    Path(out_tsv).parent.mkdir(parents=True, exist_ok=True)
    tbl.write_tsv(out_tsv, table)
    return table


class SoundscapeGenerator:
    """fg_folder: class-named subfolders of event wavs; bg_folder: wavs."""

    def __init__(self, fg_folder, bg_folder, cfg: SoundscapeConfig = SoundscapeConfig(), seed=42):
        from ..data.audio_io import read_wav, to_mono

        self._read = read_wav
        self._mono = to_mono
        self.cfg = cfg
        self.rng = np.random.default_rng(seed)
        self.fg: dict[str, list[Path]] = {}
        for class_dir in sorted(Path(fg_folder).iterdir()):
            if class_dir.is_dir():
                wavs = sorted(class_dir.glob("*.wav"))
                if wavs:
                    self.fg[class_dir.name] = wavs
        self.bg = (
            sorted(Path(bg_folder).glob("*.wav")) if bg_folder is not None else []
        )
        if not self.fg:
            raise ValueError(f"no foreground classes found under {fg_folder}")

    def _load(self, path) -> np.ndarray:
        audio, fs = self._read(path)
        audio = self._mono(audio)
        if fs != self.cfg.fs:
            from ..data.audio_io import resample

            audio = resample(audio, fs, self.cfg.fs)
        return audio.astype(np.float32)

    def _loudness_scale(self, x: np.ndarray, target_db: float) -> np.ndarray:
        if self.cfg.loudness == "lufs":
            from .dsp import scale_to_lufs

            return scale_to_lufs(x, target_db, self.cfg.fs)
        return _scale_to_db(x, target_db)

    def _n_events(self) -> int:
        # truncated normal on [0, max_events] (generate_dcase_task4_2021.py)
        v = self.rng.normal(self.cfg.event_count_mean, self.cfg.event_count_std)
        return int(np.clip(round(v), 0, self.cfg.max_events))

    # ------------------------------------------------------------------
    # sample -> metadata
    # ------------------------------------------------------------------
    def sample_metadata(self, name: str) -> dict:
        """Draw every random parameter of one soundscape (jams-equivalent)."""
        cfg = self.cfg
        n = int(cfg.duration * cfg.fs)
        meta = {
            "name": name,
            "duration": cfg.duration,
            "fs": cfg.fs,
            "ref_db": cfg.ref_db,
            "loudness": cfg.loudness,
            "background": None,
            "events": [],
        }
        if self.bg:
            bg_path = self.rng.choice(self.bg)
            bg_len = len(self._load(bg_path))
            reps = max(1, int(np.ceil(n / bg_len)))
            start = int(self.rng.integers(0, max(bg_len * reps - n, 1)))
            meta["background"] = {"path": str(bg_path), "start": start}
        lo, hi = cfg.pitch_range
        for _ in range(self._n_events()):
            label = self.rng.choice(list(self.fg.keys()))
            src_path = self.rng.choice(self.fg[label])
            src_len = len(self._load(src_path))
            if src_len < int(cfg.min_event_dur * cfg.fs):
                continue
            max_len = min(src_len, n)
            seg_len = int(self.rng.integers(int(cfg.min_event_dur * cfg.fs), max_len + 1))
            s0 = int(self.rng.integers(0, src_len - seg_len + 1))
            meta["events"].append({
                "label": str(label),
                "path": str(src_path),
                "src_start": s0,
                "length": seg_len,
                "snr": float(self.rng.uniform(*cfg.snr_range)),
                "pitch": float(self.rng.uniform(lo, hi)) if hi > lo else 0.0,
                "onset": int(self.rng.integers(0, n - seg_len + 1)),
            })
        return meta

    # ------------------------------------------------------------------
    # metadata -> audio (deterministic)
    # ------------------------------------------------------------------
    def render(self, meta: dict):
        """Deterministically render a soundscape from its metadata."""
        cfg = self.cfg
        fs = meta.get("fs", cfg.fs)
        n = int(meta.get("duration", cfg.duration) * fs)
        ref_db = meta.get("ref_db", cfg.ref_db)
        if meta.get("background"):
            bg = self._load(meta["background"]["path"])
            if len(bg) < n + meta["background"]["start"]:
                reps = int(np.ceil((n + meta["background"]["start"]) / len(bg)))
                bg = np.tile(bg, reps)
            s = meta["background"]["start"]
            mix = self._loudness_scale(bg[s : s + n], ref_db)
            bg_db = ref_db
        else:
            mix = np.zeros(n, np.float32)
            bg_db = ref_db
        events = []
        for ev in meta["events"]:
            src = self._load(ev["path"])
            seg = src[ev["src_start"] : ev["src_start"] + ev["length"]]
            if ev.get("pitch", 0.0):
                from .dsp import pitch_shift

                seg = pitch_shift(seg, ev["pitch"], fs)
            seg = self._loudness_scale(seg, bg_db + ev["snr"])
            onset = ev["onset"]
            mix[onset : onset + len(seg)] += seg
            events.append({
                "filename": f"{meta['name']}.wav",
                "onset": round(onset / fs, 3),
                "offset": round((onset + len(seg)) / fs, 3),
                "event_label": ev["label"],
            })
        peak = np.abs(mix).max()
        if peak > 0.99:  # peak protection
            mix = mix * (0.99 / peak)
        return mix.astype(np.float32), events

    def generate_one(self, name: str):
        meta = self.sample_metadata(name)
        mix, events = self.render(meta)
        return mix, events, meta

    def generate(self, n_soundscapes: int, out_audio_folder, out_tsv,
                 save_metadata: bool = True):
        from ..data.audio_io import write_wav

        out_audio_folder = Path(out_audio_folder)
        out_audio_folder.mkdir(parents=True, exist_ok=True)
        all_events = []
        for i in range(n_soundscapes):
            name = f"soundscape_{i:05d}"
            mix, events, meta = self.generate_one(name)
            write_wav(out_audio_folder / f"{name}.wav", mix, self.cfg.fs)
            if save_metadata:  # jams-equivalent sidecar
                (out_audio_folder / f"{name}.json").write_text(
                    json.dumps(meta, indent=1)
                )
            if events:
                all_events.extend(events)
            else:  # empty soundscape still gets a row with NaN label
                all_events.append(
                    {"filename": f"{name}.wav", "onset": np.nan, "offset": np.nan,
                     "event_label": np.nan}
                )
        return _write_events(all_events, out_tsv)


def rerender_subset(
    meta_folder,
    fg_folder,
    bg_folder,
    out_audio_folder,
    out_tsv,
    cfg: SoundscapeConfig = SoundscapeConfig(),
    db_decrease: float = 0.0,
    target_labels: list[str] | None = None,
    drop_nontarget: bool = False,
    keep_background: bool = True,
):
    """Re-render stored soundscapes with modified parameters (the reference's
    generate_dcase_subset.py change_snr / target-only flows): non-target
    event SNRs decreased by `db_decrease` (or events dropped entirely),
    background optionally removed. Event TABLES are identical to the
    originals up to removed rows — only gains change.
    """
    from ..data.audio_io import write_wav

    gen = SoundscapeGenerator(fg_folder, bg_folder, cfg)
    out_audio_folder = Path(out_audio_folder)
    out_audio_folder.mkdir(parents=True, exist_ok=True)
    targets = set(target_labels or [])
    all_events = []
    metas = sorted(Path(meta_folder).glob("*.json"))
    for mpath in metas:
        meta = json.loads(mpath.read_text())
        if not keep_background:
            meta["background"] = None
        new_events = []
        for ev in meta["events"]:
            is_target = not targets or ev["label"] in targets
            if not is_target:
                if drop_nontarget:
                    continue
                ev = dict(ev, snr=ev["snr"] - db_decrease)
            new_events.append(ev)
        meta["events"] = new_events
        mix, events = gen.render(meta)
        write_wav(out_audio_folder / f"{meta['name']}.wav", mix, cfg.fs)
        if events:
            all_events.extend(events)
        else:
            all_events.append(
                {"filename": f"{meta['name']}.wav", "onset": np.nan,
                 "offset": np.nan, "event_label": np.nan}
            )
    return _write_events(all_events, out_tsv)
