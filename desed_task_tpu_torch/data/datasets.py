"""Host-side SED datasets (numpy; counterpart of desed_task_tpu/data/datasets.py).

Each dataset indexes its annotations into an example table at construction
and produces per-item numpy dicts

    {"audio": f32[N], "labels": f32[C, n_frames], "class_mask": bool[C],
     "embeddings": [...] (optional, the store's dtype), "filename": str,
     "padded_ratio": f32}

for fixed-slot batching (data/batcher.py) and the device stores
(data/device_cache.py). Strong labels are shifted by the random-crop onset
(datasets.py:50-57 of the reference); weak labels occupy label-frame 0
only; unlabeled clips carry all-zero labels. Per-dataset class-validity
masks serve the 2024 multi-dataset training.

Annotations are column tables (utils/table.py: `read_tsv`) or DataFrames.
Pretrained embeddings come from an HDF5 store opened lazily, once per
process; h5py is imported there and nowhere else.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ..labels.encoder import ManyHotEncoder
from ..utils import table as tbl
from .audio_io import read_audio


def _class_mask(encoder: ManyHotEncoder, mask_events_other_than):
    if mask_events_other_than is None:
        return np.ones(len(encoder.labels), bool)
    allowed = set(mask_events_other_than)
    return np.array([lab in allowed for lab in encoder.labels], bool)


class _EmbeddingStore:
    """Lazy per-process HDF5 handle with a filename -> row index."""

    def __init__(self, hdf5_file, embedding_type):
        if embedding_type not in ("global", "frame"):
            raise ValueError(
                f"embedding type must be 'global' or 'frame', got {embedding_type!r}")
        import h5py

        self.path = hdf5_file
        self.embedding_type = embedding_type
        with h5py.File(hdf5_file, "r") as f:
            self.index = {name.decode("utf-8"): i for i, name in enumerate(f["filenames"])}
        self._handle = None

    @property
    def handle(self):
        if self._handle is None:
            import h5py

            self._handle = h5py.File(self.path, "r")
        return self._handle

    def get(self, stem: str) -> np.ndarray:
        i = self.index[stem]
        key = "global_embeddings" if self.embedding_type == "global" else "frame_embeddings"
        # the on-disk dtype is kept (float16 stores halve the bytes to the
        # card); the train step casts on the device
        return np.asarray(self.handle[key][i])


class _BaseSet:
    def __init__(
        self,
        encoder: ManyHotEncoder,
        pad_to: float | None = 10,
        fs: int = 16000,
        return_filename: bool = False,
        random_channel: bool = False,
        multisrc: bool = False,
        embeddings_hdf5_file=None,
        embedding_type=None,
        mask_events_other_than=None,
        test: bool = False,
    ):
        self.encoder = encoder
        self.fs = fs
        self.pad_to = int(pad_to * fs) if pad_to is not None else None
        self.return_filename = return_filename
        self.random_channel = random_channel
        self.multisrc = multisrc
        self.test = test
        self.class_mask = _class_mask(encoder, mask_events_other_than)
        self.embeddings = (
            _EmbeddingStore(embeddings_hdf5_file, embedding_type)
            if embeddings_hdf5_file is not None
            else None
        )
        self.examples: dict[str, dict] = {}
        self.examples_list: list[str] = []

    def __len__(self):
        return len(self.examples_list)

    def _load(self, path):
        return read_audio(path, multisrc=self.multisrc, random_channel=self.random_channel,
                          pad_to=self.pad_to, test=self.test)

    def _finalize(self, out, path):
        if self.embeddings is not None:
            out["embeddings"] = self.embeddings.get(Path(path).stem)
        out["class_mask"] = self.class_mask
        if self.return_filename:
            out["filename"] = path
        return out


class StronglyAnnotatedSet(_BaseSet):
    """Clips with event-level annotations: a table with filename, onset,
    offset, event_label and optionally confidence. A row with any missing
    field drops (DataFrame.dropna()), so a clip whose only row has no event
    is not in the set."""

    def __init__(self, audio_folder, tsv_entries, encoder, **kwargs):
        super().__init__(encoder, **kwargs)
        t = tbl.dropna(tsv_entries)
        conf = t.get("confidence")
        for i, name in enumerate(t["filename"]):
            ex = self.examples.setdefault(
                name, {"path": str(Path(audio_folder) / name), "events": []})
            ex["events"].append((t["event_label"][i], float(t["onset"][i]),
                                 float(t["offset"][i]),
                                 1.0 if conf is None else float(conf[i])))
        self.examples_list = list(self.examples)

    def __getitem__(self, item):
        ex = self.examples[self.examples_list[item]]
        audio, onset_s, offset_s, padded = self._load(ex["path"])
        # labels shifted into the crop window (process_labels, datasets.py:50-57)
        events = []
        for label, on, off, conf in ex["events"]:
            on2 = max(0.0, on - onset_s)
            off2 = min(self.encoder.audio_len, off - onset_s)
            if on2 < off2:
                events.append((label, on2, off2, conf))
        strong = self.encoder.encode_strong(events)
        out = {
            "audio": audio,
            "labels": strong.T.astype(np.float32),  # [C, n_frames]
            "padded_ratio": np.float32(padded),
        }
        return self._finalize(out, ex["path"])


class WeakSet(_BaseSet):
    """Clips with clip-level labels (columns filename, event_labels,
    comma-separated). The weak multi-hot occupies label-frame 0 only."""

    def __init__(self, audio_folder, tsv_entries, encoder, **kwargs):
        super().__init__(encoder, **kwargs)
        t = tbl.as_columns(tsv_entries)
        for name, labels in zip(t["filename"], t["event_labels"]):
            self.examples.setdefault(
                name, {"path": str(Path(audio_folder) / name), "events": labels.split(",")})
        self.examples_list = list(self.examples)

    def __getitem__(self, item):
        ex = self.examples[self.examples_list[item]]
        audio, *_rest, padded = self._load(ex["path"])
        labels = np.zeros((self.encoder.n_frames, len(self.encoder.labels)), np.float32)
        if ex["events"]:
            labels[0, :] = self.encoder.encode_weak(ex["events"])
        out = {"audio": audio, "labels": labels.T, "padded_ratio": np.float32(padded)}
        return self._finalize(out, ex["path"])


class UnlabeledSet(_BaseSet):
    """A folder of unannotated wavs; labels all zero."""

    def __init__(self, unlabeled_folder, encoder, **kwargs):
        super().__init__(encoder, **kwargs)
        for p in sorted(Path(unlabeled_folder).glob("*.wav")):
            self.examples[p.name] = {"path": str(p)}
        self.examples_list = list(self.examples)

    def __getitem__(self, item):
        ex = self.examples[self.examples_list[item]]
        audio, *_rest, padded = self._load(ex["path"])
        labels = np.zeros((len(self.encoder.labels), self.encoder.n_frames), np.float32)
        out = {"audio": audio, "labels": labels, "padded_ratio": np.float32(padded)}
        return self._finalize(out, ex["path"])


class ConcatSet:
    """Several datasets in one index space (the reference's ConcatDataset
    that folds AudioSet strong clips into the synth slot under --strong_real,
    dcase2022_task4_baseline/train_sed.py:163-167)."""

    def __init__(self, parts):
        self.parts = list(parts)
        if not self.parts:
            raise ValueError("ConcatSet needs at least one dataset")
        self.encoder = self.parts[0].encoder

    def __len__(self):
        return sum(len(p) for p in self.parts)

    def __getitem__(self, item):
        for p in self.parts:
            if item < len(p):
                return p[item]
            item -= len(p)
        raise IndexError(item)


class SeparatedSet(_BaseSet):
    """Clips with pre-separated sources (the 2021 separation recipe): for
    each base clip `X.wav` the separation runner (tools/separation.py
    `separate_folder`) writes `X_src{i}.wav`; items are the base clip's item
    plus "sources" [n_src, N] (zeros for a missing source file). With
    `sources_as_audio`, "audio" is the sources too, as the ensemble's train
    and predict steps read it (training/sepsed.py)."""

    def __init__(self, separated_folder, base_dataset: _BaseSet, n_src: int = 4,
                 sources_as_audio: bool = False):
        self.base = base_dataset
        self.separated_folder = Path(separated_folder)
        self.n_src = n_src
        self.sources_as_audio = sources_as_audio
        self.encoder = base_dataset.encoder
        self.fs = base_dataset.fs
        self.pad_to = base_dataset.pad_to
        self.test = base_dataset.test
        self.examples_list = base_dataset.examples_list

    def __len__(self):
        return len(self.base)

    def __getitem__(self, item):
        out = dict(self.base[item])
        stem = Path(self.base.examples[self.base.examples_list[item]]["path"]).stem
        sources = []
        for i in range(self.n_src):
            src_path = self.separated_folder / f"{stem}_src{i}.wav"
            if src_path.exists():
                audio, *_ = read_audio(str(src_path), pad_to=self.pad_to, test=True)
            else:
                audio = np.zeros(self.pad_to, np.float32)
            sources.append(audio)
        out["sources"] = np.stack(sources)  # [n_src, N]
        if self.sources_as_audio:
            out["audio"] = out["sources"]
        return out
