"""The recipe's host data path of the port against the JAX package on the same
files: `read_tsv` against pandas, `process_tsvs`, every dataset class's items
(from a DataFrame and from a column table, embeddings from an HDF5 store
written with h5py), `dropna` semantics, `ConcatSet`, and the batcher's
index streams and batches. All bitwise."""

import random

import h5py
import numpy as np
import pandas as pd
import pytest

from desed_task_tpu.data import batcher as jbatcher
from desed_task_tpu.data import datasets as jds
from desed_task_tpu.labels.encoder import CatManyHotEncoder as JCat
from desed_task_tpu.labels.encoder import ManyHotEncoder as JEnc
from desed_task_tpu.utils import classes_dict as jcd
from desed_task_tpu_torch.data import batcher as tbatcher
from desed_task_tpu_torch.data import datasets as tds
from desed_task_tpu_torch.data.audio_io import write_wav
from desed_task_tpu_torch.labels.encoder import CatManyHotEncoder, ManyHotEncoder
from desed_task_tpu_torch.utils import classes_dict as tcd
from desed_task_tpu_torch.utils import table as tbl

DESED = list(tcd.CLASSES_DESED)
MAESTRO = list(tcd.CLASSES_MAESTRO_REAL)
ENC_ARGS = (2, 1024, 256, 4, 16000)  # audio_len, frame_len, hop, net_pooling, fs


def _write_tsv(path, text):
    path.write_text(text)
    return path


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Wavs (2 s, one 1.5 s clip that pads, one 3 s clip that crops), tsvs
    with empty fields, and a float16 frame-embedding store."""
    root = tmp_path_factory.mktemp("recipe_data")
    rng = np.random.default_rng(7)
    (root / "audio").mkdir()
    lengths = {f"c{i}.wav": 32000 for i in range(8)}
    lengths["c6.wav"] = 24000
    lengths["c7.wav"] = 48000
    for name, n in lengths.items():
        write_wav(root / "audio" / name, (rng.standard_normal(n) * 0.1).astype(np.float32),
                  16000)
    strong = _write_tsv(root / "strong.tsv", (
        "filename\tonset\toffset\tevent_label\tconfidence\n"
        "c0.wav\t0.2\t1.5\tDog\t0.9\n"
        "c0.wav\t1.0\t1.9\tpeople talking\t0.4\n"
        "c1.wav\t0.0\t2.0\tSpeech\t\n"          # empty confidence: the row drops
        "c2.wav\t\t\t\t\n"                      # a clip with no event: it drops
        "c3.wav\t0.5\t0.75\tcutlery and dishes\t1.0\n"
        "c6.wav\t0.1\t1.4\tCat\t1.0\n"
        "c7.wav\t0.3\t2.9\tBlender\t0.7\n"
        "c3.wav\t1.25\t1.5\tcar\t0.6\n"))
    weak = _write_tsv(root / "weak.tsv", (
        "filename\tevent_labels\n"
        "c4.wav\tDog,Cat\nc5.wav\tSpeech\nc6.wav\tBlender,Dishes,Frying\nc7.wav\tCat\n"))
    with h5py.File(root / "emb.hdf5", "w") as f:
        f["filenames"] = np.asarray([f"c{i}".encode() for i in range(8)])
        f["frame_embeddings"] = rng.standard_normal((8, 6, 5)).astype(np.float16)
    return root, strong, weak


def _encoders(maestro: bool):
    if not maestro:
        return JEnc(DESED, *ENC_ARGS), ManyHotEncoder(DESED, *ENC_ARGS)
    return (JCat((JEnc(DESED, *ENC_ARGS), JEnc(MAESTRO, *ENC_ARGS))),
            CatManyHotEncoder((ManyHotEncoder(DESED, *ENC_ARGS),
                               ManyHotEncoder(MAESTRO, *ENC_ARGS))))


def _same_items(a, b):
    assert len(a) == len(b)
    for i in range(len(a)):
        random.seed(i)
        x = a[i]
        random.seed(i)
        y = b[i]
        assert set(x) == set(y)
        for k in x:
            if isinstance(x[k], str):
                assert x[k] == y[k], k
            else:
                assert np.asarray(x[k]).dtype == np.asarray(y[k]).dtype, k
                np.testing.assert_array_equal(y[k], x[k], err_msg=k)


@pytest.mark.parametrize("name", ["strong", "weak"])
def test_read_tsv_matches_pandas(files, name):
    root, strong, weak = files
    path = {"strong": strong, "weak": weak}[name]
    got, want = tbl.read_tsv(path), pd.read_csv(path, sep="\t")
    assert list(got) == list(want.columns)
    for c in want.columns:
        w = want[c].to_numpy()
        if want[c].dtype.kind == "f":
            assert got[c].dtype == np.float64, c
            np.testing.assert_array_equal(got[c], w, err_msg=c)
        else:
            assert [tbl.is_missing(v) for v in got[c]] == list(pd.isna(w)), c
            assert [v for v in got[c] if not tbl.is_missing(v)] == [v for v in w if not
                                                                    pd.isna(v)], c


def test_dropna_and_take_match_pandas(files):
    _, strong, _ = files
    want = pd.read_csv(strong, sep="\t").dropna()
    got = tbl.dropna(tbl.read_tsv(strong))
    assert tbl.n_rows(got) == len(want) == 6
    assert list(got["filename"]) == list(want["filename"])
    np.testing.assert_array_equal(got["onset"], want["onset"].to_numpy())
    rows = np.array([3, 0, 2])
    taken = tbl.take(got, rows)
    assert list(taken["event_label"]) == list(want.iloc[rows]["event_label"])


def _labels(col):
    return [None if pd.isna(v) else v for v in col]


def test_process_tsvs_matches_jax(files):
    _, strong, _ = files
    want = jcd.process_tsvs(pd.read_csv(strong, sep="\t"))
    for source in (tbl.read_tsv(strong), pd.read_csv(strong, sep="\t")):
        got = tcd.process_tsvs(source)
        assert tbl.n_rows(got) == len(want) == 10
        assert list(got["filename"]) == list(want["filename"])
        assert _labels(got["event_label"]) == _labels(want["event_label"])
        np.testing.assert_array_equal(got["confidence"], want["confidence"].to_numpy())


def test_classes_dict_matches_jax():
    assert tcd.CLASSES_MAESTRO_SYNTH == jcd.CLASSES_MAESTRO_SYNTH
    assert tcd.CLASSES_MAESTRO_REAL_EVAL == jcd.CLASSES_MAESTRO_REAL_EVAL
    assert tcd.MAESTRO_DESED_ALIAS == jcd.MAESTRO_DESED_ALIAS


@pytest.mark.parametrize("source", ["dataframe", "table"])
@pytest.mark.parametrize("kind", ["strong", "weak", "unlabeled"])
@pytest.mark.parametrize("test_mode", [False, True])
def test_dataset_items_match_jax(files, source, kind, test_mode):
    root, strong, weak = files
    maestro = kind == "strong"
    jenc, tenc = _encoders(maestro)
    kw = dict(pad_to=2, fs=16000, test=test_mode, return_filename=True,
              embeddings_hdf5_file=str(root / "emb.hdf5"), embedding_type="frame",
              mask_events_other_than=DESED + ["people talking"] if maestro else None)
    read = (lambda p: pd.read_csv(p, sep="\t")) if source == "dataframe" else tbl.read_tsv
    audio = str(root / "audio")
    if kind == "strong":
        a = jds.StronglyAnnotatedSet(audio, pd.read_csv(strong, sep="\t"), jenc, **kw)
        b = tds.StronglyAnnotatedSet(audio, read(strong), tenc, **kw)
        # the clip whose only row has no event and the row without a
        # confidence drop, as DataFrame.dropna() drops them
        assert b.examples_list == a.examples_list == ["c0.wav", "c3.wav", "c6.wav", "c7.wav"]
    elif kind == "weak":
        a = jds.WeakSet(audio, pd.read_csv(weak, sep="\t"), jenc, **kw)
        b = tds.WeakSet(audio, read(weak), tenc, **kw)
    else:
        a = jds.UnlabeledSet(audio, jenc, **kw)
        b = tds.UnlabeledSet(audio, tenc, **kw)
    assert b.examples_list == a.examples_list
    _same_items(a, b)
    assert b[0]["embeddings"].dtype == np.float16


def test_concat_set_matches_jax(files):
    root, strong, weak = files
    jenc, tenc = _encoders(False)
    kw = dict(pad_to=2, fs=16000, test=True)
    a = jds.ConcatSet([jds.WeakSet(str(root / "audio"), pd.read_csv(weak, sep="\t"), jenc, **kw),
                       jds.UnlabeledSet(str(root / "audio"), jenc, **kw)])
    b = tds.ConcatSet([tds.WeakSet(str(root / "audio"), tbl.read_tsv(weak), tenc, **kw),
                       tds.UnlabeledSet(str(root / "audio"), tenc, **kw)])
    assert len(b) == len(a) == 12
    _same_items(a, b)
    with pytest.raises(IndexError):
        b[12]


class _Range:
    """A dataset whose item i is a small deterministic dict."""

    def __init__(self, n, tag):
        self.n, self.tag = n, tag

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"audio": np.full(4, self.tag * 100 + i, np.float32),
                "labels": np.full((2, 3), i, np.float32)}


@pytest.mark.parametrize("shard", [(0, 1), (1, 2)])
def test_batcher_streams_match_jax(shard):
    sizes = {"a": (11, 2), "b": (7, 3), "c": (20, 4)}
    ds = {k: _Range(n, i) for i, (k, (n, _)) in enumerate(sizes.items())}
    bs = {k: b for k, (_, b) in sizes.items()}
    kw = dict(seed=5, shard_index=shard[0], num_shards=shard[1], num_workers=2, prefetch=2)
    ja, ta = jbatcher.MultiSourceBatcher(ds, bs, **kw), tbatcher.MultiSourceBatcher(ds, bs, **kw)
    assert ta.steps_per_epoch == ja.steps_per_epoch
    for _ in range(3):  # three epochs: the smaller slots wrap and reshuffle
        for x, y in zip(ja.epoch_indices(), ta.epoch_indices(), strict=True):
            assert x.keys() == y.keys()
            for k in x:
                np.testing.assert_array_equal(y[k], x[k])
                assert y[k].dtype == np.int64
    jb, tb = jbatcher.MultiSourceBatcher(ds, bs, **kw), tbatcher.MultiSourceBatcher(ds, bs, **kw)
    for _ in range(2):
        for x, y in zip(jb.epoch(), tb.epoch(), strict=True):
            for k in x:
                for leaf in x[k]:
                    np.testing.assert_array_equal(y[k][leaf], x[k][leaf])
    # a partial epoch leaves both streams at the same point
    next(iter(jb.epoch(steps=1)))
    next(iter(tb.epoch(steps=1)))
    assert tb.samplers["c"].take(5) == jb.samplers["c"].take(5)


def test_slot_sampler_matches_jax():
    for shard_index, num_shards in ((1, 3), (0, 1)):
        a = jbatcher.SlotSampler(9, 3, shard_index, num_shards)
        b = tbatcher.SlotSampler(9, 3, shard_index, num_shards)
        assert b.shard_len == a.shard_len == 9 // num_shards
        for k in (2, 5, 1, 7):
            assert b.take(k) == a.take(k)


def test_batcher_raises_a_dataset_error():
    class Bad(_Range):
        def __getitem__(self, i):
            raise OSError("unreadable clip")

    b = tbatcher.MultiSourceBatcher({"a": Bad(4, 0)}, {"a": 2}, num_workers=1)
    with pytest.raises(OSError, match="unreadable"):
        list(b.epoch())
