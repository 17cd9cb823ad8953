"""End-to-end quickstart on fully self-generated data (counterpart of
examples/quickstart_synthetic.py).

Needs no download: it synthesizes a labeled soundbank of tone-based events,
generates soundscapes with the scaper-equivalent generator
(tools/soundscapes.py), then runs the 2021-style recipe (mean-teacher CRNN)
through the port's single_run on the card: training, validation with the
PSDS-family metrics, checkpoints and the dev-test battery.

    python -m desed_task_tpu_torch.recipes.quickstart_synthetic \\
        --workdir /tmp/quickstart [--epochs 10] [--n_train 120] [--fast_dev_run]

Events are class-distinct tones and noises, so a model separates them
within a few epochs; the script prints the dev-test metrics.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from ..data.audio_io import write_wav
from ..tools.soundscapes import SoundscapeConfig, SoundscapeGenerator
from ..utils import table as tbl

FS = 16000
CLASSES = {
    "Alarm_bell_ringing": lambda t, rng: np.sin(2 * np.pi * 880 * t) * (np.sin(2 * np.pi * 4 * t) > 0),
    "Blender": lambda t, rng: rng.standard_normal(t.shape) * np.sin(2 * np.pi * 120 * t),
    "Cat": lambda t, rng: np.sin(2 * np.pi * (600 + 400 * t / t[-1]) * t),
    "Dishes": lambda t, rng: rng.standard_normal(t.shape) * (np.sin(2 * np.pi * 12 * t) > 0.8),
    "Dog": lambda t, rng: np.sin(2 * np.pi * 250 * t) * np.exp(-8 * (t % 0.3)),
    "Electric_shaver_toothbrush": lambda t, rng: np.sign(np.sin(2 * np.pi * 150 * t)) * 0.7,
    "Frying": lambda t, rng: rng.standard_normal(t.shape) * 0.6,
    "Running_water": lambda t, rng: np.cumsum(rng.standard_normal(t.shape)) / 50,
    "Speech": lambda t, rng: np.sin(2 * np.pi * (200 + 80 * np.sin(2 * np.pi * 3 * t)) * t),
    "Vacuum_cleaner": lambda t, rng: np.sin(2 * np.pi * 90 * t) + 0.4 * rng.standard_normal(t.shape),
}


def make_soundbank(root: Path, rng) -> Path:
    """foreground/<class>/<class>_{0..3}.wav and background/bg_{0..2}.wav
    under root/soundbank, drawn from rng."""
    fg = root / "soundbank" / "foreground"
    bg = root / "soundbank" / "background"
    bg.mkdir(parents=True, exist_ok=True)
    for name, fn in CLASSES.items():
        d = fg / name
        d.mkdir(parents=True, exist_ok=True)
        for i in range(4):
            dur = rng.uniform(0.6, 3.0)
            t = np.arange(int(dur * FS)) / FS
            x = fn(t, rng).astype(np.float32)
            x *= 0.3 / (np.abs(x).max() + 1e-6)
            write_wav(d / f"{name}_{i}.wav", x, FS)
    for i in range(3):
        x = (rng.standard_normal(FS * 15) * 0.02).astype(np.float32)
        write_wav(bg / f"bg_{i}.wav", x, FS)
    return root / "soundbank"


def generate_corpus(root: Path, soundbank: Path, n_train: int, seed=0) -> dict:
    """The synth, synth_val, test, weak and unlab splits under root/audio,
    their tsvs under root/meta (durations for synth_val and test, clip
    labels for weak); returns {split: (audio folder, tsv, event table)}."""
    layout = {}
    for split, n, s in [
        ("synth", n_train, seed),
        ("synth_val", max(n_train // 4, 8), seed + 1),
        ("test", max(n_train // 4, 8), seed + 2),
        ("weak", n_train // 2, seed + 3),
        ("unlab", n_train // 2, seed + 4),
    ]:
        gen = SoundscapeGenerator(
            soundbank / "foreground", soundbank / "background",
            SoundscapeConfig(duration=10.0), seed=s,
        )
        out_audio = root / "audio" / split
        table = gen.generate(n, out_audio, root / "meta" / f"{split}.tsv")
        layout[split] = (out_audio, root / "meta" / f"{split}.tsv", table)
    for split in ("synth_val", "test"):
        files = sorted((root / "audio" / split).glob("*.wav"))
        tbl.write_tsv(root / "meta" / f"{split}_dur.tsv",
                      {"filename": np.asarray([f.name for f in files], object),
                       "duration": np.full(len(files), 10.0)})
    weak = tbl.dropna(layout["weak"][2])
    names = sorted(set(weak["filename"]))
    labels = {n: set() for n in names}
    for f, lab in zip(weak["filename"], weak["event_label"]):
        labels[f].add(lab)
    tbl.write_tsv(root / "meta" / "weak.tsv",
                  {"filename": np.asarray(names, object),
                   "event_labels": np.asarray([",".join(sorted(labels[n])) for n in names],
                                              object)})
    return layout


def make_config(root: Path, epochs: int) -> dict:
    """The example's recipe configuration, its data paths under root."""
    return {
        "training": {
            "batch_size": [8, 8, 16],
            "batch_size_val": 16,
            "const_max": 2,
            "n_epochs_warmup": max(epochs // 2, 1),
            "num_workers": 4,
            "n_epochs": epochs,
            "gradient_clip": 5.0,
            "n_test_thresholds": 10,
            "ema_factor": 0.999,
            "self_sup_loss": "mse",
            "validation_interval": 1,
            "weak_split": 0.9,
            "seed": 42,
            "mixup": "soft",
            "mixup_prob": 0.5,
            "obj_metric_synth_type": "intersection",
        },
        "scaler": {"statistic": "instance", "normtype": "minmax", "dims": [1, 2]},
        "data": {
            "synth_folder": str(root / "audio" / "synth"),
            "synth_tsv": str(root / "meta" / "synth.tsv"),
            "weak_folder": str(root / "audio" / "weak"),
            "weak_tsv": str(root / "meta" / "weak.tsv"),
            "unlabeled_folder": str(root / "audio" / "unlab"),
            "synth_val_folder": str(root / "audio" / "synth_val"),
            "synth_val_tsv": str(root / "meta" / "synth_val.tsv"),
            "synth_val_dur": str(root / "meta" / "synth_val_dur.tsv"),
            "test_folder": str(root / "audio" / "test"),
            "test_tsv": str(root / "meta" / "test.tsv"),
            "test_dur": str(root / "meta" / "test_dur.tsv"),
            "audio_max_len": 10,
            "fs": FS,
            "net_subsample": 4,
        },
        "opt": {"lr": 0.001},
        "feats": {
            "n_mels": 128, "n_filters": 2048, "hop_length": 256,
            "n_window": 2048, "sample_rate": FS, "f_min": 0, "f_max": 8000,
        },
        "net": {
            "dropout": 0.3,
            "n_layers_RNN": 2,
            "n_in_channel": 1,
            "nclass": 10,
            "attention": True,
            "n_RNN_cell": 64,
            "activation": "glu",
            "rnn_type": "BGRU",
            "kernel_size": [3] * 7,
            "padding": [1] * 7,
            "stride": [1] * 7,
            "nb_filters": [16, 32, 64, 128, 128, 128, 128],
            "pooling": [[2, 2], [2, 2], [1, 2], [1, 2], [1, 2], [1, 2], [1, 2]],
            "median_filter": 7,
        },
    }


def main(argv=None, device=None, training: dict | None = None, run_info: dict | None = None):
    """Generate the data under --workdir and train on `device` (default
    "cuda"); `training` updates the config's training section (e.g.
    device_watts off the card), `run_info` receives single_run's parts.
    Returns (state, dev-test results)."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--workdir", default="./quickstart_data")
    parser.add_argument("--epochs", type=int, default=10)
    parser.add_argument("--n_train", type=int, default=120)
    parser.add_argument("--fast_dev_run", action="store_true")
    args = parser.parse_args(argv)

    from ..device import resolve_device
    from ..training.single_run import single_run

    device = resolve_device(device)  # no card: raise before generating anything
    root = Path(args.workdir)
    rng = np.random.default_rng(0)
    print("[1/3] synthesizing soundbank + soundscapes ...")
    soundbank = make_soundbank(root, rng)
    generate_corpus(root, soundbank, args.n_train)

    config = make_config(root, args.epochs)
    config["training"].update(training or {})
    print("[2/3] training ...")
    state, results = single_run(config, str(root / "exp"), fast_dev_run=args.fast_dev_run,
                                device=device, run_info=run_info)
    print("[3/3] dev-test results:")
    for k, v in (results or {}).items():
        if isinstance(v, float):
            print(f"  {k}: {v:.4f}")
    return state, results


if __name__ == "__main__":
    main()
