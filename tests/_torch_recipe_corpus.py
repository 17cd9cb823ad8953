"""A small DESED-layout corpus and recipe config for the port's recipe tests.

The layout and contents of tests/test_single_run.py's fixture (2-s clips,
3 slots: synth, weak, unlabeled; synth_val and test with durations), and
its 5-slot 2024 layout with MAESTRO windows, written without pandas (the
port's write_wav, tsv files with csv). Optionally one frame-embedding HDF5
store per split (h5py), as the recipe's `pretrained.extracted_embeddings_dir`
layout names them.
"""

from __future__ import annotations

import csv
from pathlib import Path

import numpy as np

from desed_task_tpu_torch.data.audio_io import write_wav
from desed_task_tpu_torch.utils.classes_dict import CLASSES_DESED

CLASSES = list(CLASSES_DESED.keys())
SECS = 2


def write_tsv(path, header, rows):
    with open(path, "w", newline="") as f:
        w = csv.writer(f, delimiter="\t", lineterminator="\n")
        w.writerow(header)
        w.writerows(rows)


def write_corpus(root: Path) -> Path:
    """The 3-slot corpus of tests/test_single_run.py and the MAESTRO windows
    of its 2024 test, under root."""
    rng = np.random.default_rng(3)
    for sub, n in [("synth", 6), ("weak", 6), ("unlab", 6), ("synth_val", 4), ("test", 4)]:
        (root / sub).mkdir(parents=True)
        for i in range(n):
            x = (rng.standard_normal(SECS * 16000) * 0.1).astype(np.float32)
            write_wav(root / sub / f"{sub}_{i}.wav", x, 16000)
    meta = root / "meta"
    meta.mkdir()
    strong = lambda sub, n: [(f"{sub}_{i}.wav", 0.2, 1.5, CLASSES[i % len(CLASSES)])
                             for i in range(n)]
    head = ["filename", "onset", "offset", "event_label"]
    write_tsv(meta / "synth.tsv", head, strong("synth", 6))
    write_tsv(meta / "weak.tsv", ["filename", "event_labels"],
              [(f"weak_{i}.wav", CLASSES[i % len(CLASSES)]) for i in range(6)])
    write_tsv(meta / "synth_val.tsv", head, strong("synth_val", 4))
    write_tsv(meta / "test.tsv", head, strong("test", 4))
    for name in ("synth_val", "test"):
        write_tsv(meta / f"{name}_dur.tsv", ["filename", "duration"],
                  [(f"{name}_{i}.wav", float(SECS)) for i in range(4)])

    rng = np.random.default_rng(21)
    m_dir = root / "maestro"
    m_dir.mkdir()
    rows = []
    for scene in ["cafe_restaurant", "city_center"]:
        for fidx in range(3):
            for onset in [0, 100]:  # two 2-s windows, onsets in centiseconds
                name = f"{scene}_{fidx:02d}-{onset:06d}-{onset + 200:06d}"
                write_wav(m_dir / f"{name}.wav",
                          (rng.standard_normal(32000) * 0.1).astype(np.float32), 16000)
                rows.append((f"{name}.wav", 0.3, 1.2, "people talking", 0.9))
                rows.append((f"{name}.wav", 0.5, 1.8, "footsteps", 0.8))
    write_tsv(meta / "maestro.tsv", head + ["confidence"], rows)
    return root


def make_config(root: Path) -> dict:
    """tests/test_single_run.py's make_config, plus the port's device_watts
    (the energy estimate's watts off the card)."""
    return {
        "training": {
            "batch_size": [2, 2, 2], "batch_size_val": 4, "const_max": 2,
            "n_epochs_warmup": 1, "num_workers": 2, "n_epochs": 2, "gradient_clip": 5.0,
            "n_test_thresholds": 3, "ema_factor": 0.999, "self_sup_loss": "mse",
            "validation_interval": 1, "weak_split": 0.9, "seed": 42, "mixup": "soft",
            "mixup_prob": 0.5, "obj_metric_synth_type": "intersection", "device_watts": 50.0,
        },
        "scaler": {"statistic": "instance", "normtype": "minmax", "dims": [1, 2]},
        "data": {
            "synth_folder": str(root / "synth"),
            "synth_tsv": str(root / "meta" / "synth.tsv"),
            "weak_folder": str(root / "weak"),
            "weak_tsv": str(root / "meta" / "weak.tsv"),
            "unlabeled_folder": str(root / "unlab"),
            "synth_val_folder": str(root / "synth_val"),
            "synth_val_tsv": str(root / "meta" / "synth_val.tsv"),
            "synth_val_dur": str(root / "meta" / "synth_val_dur.tsv"),
            "test_folder": str(root / "test"),
            "test_tsv": str(root / "meta" / "test.tsv"),
            "test_dur": str(root / "meta" / "test_dur.tsv"),
            "audio_max_len": SECS, "fs": 16000, "net_subsample": 4,
        },
        "opt": {"lr": 0.001},
        "feats": {"n_mels": 64, "n_filters": 1024, "hop_length": 256, "n_window": 1024,
                  "sample_rate": 16000, "f_min": 0, "f_max": 8000},
        "net": {
            "dropout": 0.2, "n_layers_RNN": 1, "n_in_channel": 1, "nclass": 10,
            "attention": True, "n_RNN_cell": 16, "activation": "glu", "rnn_type": "BGRU",
            "kernel_size": [3, 3], "padding": [1, 1], "stride": [1, 1], "nb_filters": [8, 8],
            "pooling": [[2, 8], [2, 8]], "median_filter": 3,
        },
    }


def config_2024(root: Path) -> dict:
    """The 5-slot 2024 layout of tests/test_single_run.py's MAESTRO test."""
    config = make_config(root)
    config["data"]["real_maestro_train_folder"] = str(root / "maestro")
    config["data"]["real_maestro_train_tsv"] = str(root / "meta" / "maestro.tsv")
    config["data"]["strong_folder"] = str(root / "synth")
    config["data"]["strong_tsv"] = str(root / "meta" / "synth.tsv")
    config["training"]["batch_size"] = [2, 2, 2, 2, 2]
    config["training"]["maestro_split"] = 0.7
    config["net"]["nclass"] = 27
    return config


def write_embeddings(root: Path, config: dict, dim: int = 6, frames: int = 5) -> dict:
    """One float16 frame-embedding HDF5 store per split the recipe reads
    (filenames, frame_embeddings [n, dim, frames]); turns the config's net
    to pool1d embeddings. Returns the config."""
    import h5py

    d = root / "embeddings" / "beats"
    d.mkdir(parents=True, exist_ok=True)
    data = config["data"]
    rng = np.random.default_rng(5)
    splits = {"synth_train": data["synth_folder"], "weak_train": data["weak_folder"],
              "unlabeled_train": data["unlabeled_folder"], "synth_val": data["synth_val_folder"],
              "devtest": data["test_folder"]}
    if "real_maestro_train_folder" in data:
        splits["maestro_real_train"] = data["real_maestro_train_folder"]
    if "strong_folder" in data:
        splits["strong_train"] = data["strong_folder"]
    for split, folder in splits.items():
        stems = sorted(p.stem for p in Path(folder).glob("*.wav"))
        with h5py.File(d / f"{split}.hdf5", "w") as f:
            f["filenames"] = np.asarray([s.encode() for s in stems])
            f["frame_embeddings"] = rng.standard_normal((len(stems), dim, frames)).astype(
                np.float16)
    config["pretrained"] = {"model": "beats", "extracted_embeddings_dir": str(root / "embeddings")}
    config["net"].update(use_embeddings=True, embedding_size=dim, embedding_type="frame",
                         aggregation_type="pool1d")
    return config
