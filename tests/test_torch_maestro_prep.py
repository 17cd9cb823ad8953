"""The port's MAESTRO preparation against desed_task_tpu.data.maestro_prep
on seeded long files: chunk indices, annotation clipping, the annotation
reader, the windows (names, audio, events), the folder preparation (its
table against JAX's DataFrame, the chunks' wavs) at a rate that needs
resampling, and the seeded dev split. Windows and events are exact, but
for times read from a text file: the port parses them with float(), which
rounds correctly, and pandas' default parser can land one unit in the last
place away (TOL_PARSE). The resampled PCM16 chunks are within one step."""

import numpy as np
import pytest

from desed_task_tpu.data import maestro_prep as jm
from desed_task_tpu_torch.data import maestro_prep as m
from desed_task_tpu_torch.data.audio_io import read_wav, write_wav
from desed_task_tpu_torch.inference.maestro import merge_maestro_ground_truth
from desed_task_tpu_torch.utils import table as tbl

TOL_PARSE = 1e-15  # relative: one unit in the last place of a float64
TOL_SHIFTED = 1e-13  # seconds: such a unit after a window's start is subtracted


def _same_events(ours: list, theirs: list):
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        assert a["event_label"] == b["event_label"] and a.keys() == b.keys()
        for k in ("onset", "offset", "confidence"):
            np.testing.assert_allclose(a[k], b[k], rtol=TOL_PARSE, atol=0)


@pytest.mark.parametrize("n,window,hop", [(35, 10, 5), (20, 10, 5), (7, 10, 5),
                                           (0, 10, 1), (160000 * 3 + 17, 160000, 16000)])
def test_chunk_indices_match_jax(n, window, hop):
    assert m.get_chunk_indices(n, window, hop) == jm.get_chunk_indices(n, window, hop)


def _events(seed, n=12, span=60.0):
    rng = np.random.default_rng(seed)
    on = np.sort(rng.uniform(0, span, n))
    return [{"onset": float(a), "offset": float(a + rng.uniform(0.2, 8.0)),
             "event_label": str(rng.choice(["car", "footsteps", "people talking"])),
             "confidence": float(rng.uniform(0.5, 1.0))} for a in on]


@pytest.mark.parametrize("start,end", [(0.0, 10.0), (5.0, 15.0), (33.3, 43.3), (55.0, 65.0)])
def test_clip_annotation_matches_jax(start, end):
    ev = _events(1)
    assert m.clip_annotation(ev, start, end) == jm.clip_annotation(ev, start, end)


@pytest.mark.parametrize("with_conf", [True, False])
def test_read_annotation_matches_jax(tmp_path, with_conf):
    ev = _events(2)
    path = tmp_path / "ann.txt"
    path.write_text("".join(
        f"{e['onset']}\t{e['offset']}\t{e['event_label']}"
        + (f"\t{e['confidence']}" if with_conf else "") + "\n" for e in ev))
    ours = m.read_maestro_annotation(path)
    _same_events(ours, jm.read_maestro_annotation(path))
    # the port's parse is the exact one
    assert [e["onset"] for e in ours] == [e["onset"] for e in ev]


@pytest.mark.parametrize("hop", [1.0, 5.0])
def test_split_long_file_matches_jax(hop):
    fs = 1000
    audio = np.random.default_rng(3).standard_normal(fs * 37).astype(np.float32)
    ev = _events(4, span=37.0)
    ours = list(m.split_long_file(audio, fs, ev, "cafe_restaurant_01", 10.0, hop))
    theirs = list(jm.split_long_file(audio, fs, ev, "cafe_restaurant_01", 10.0, hop))
    assert [c[0] for c in ours] == [c[0] for c in theirs]
    assert all(np.array_equal(a[1], b[1]) and a[2] == b[2] for a, b in zip(ours, theirs))
    # the names are the ones inference/maestro.py reassembles into the file
    gt = {name: [(e["onset"], e["offset"], e["event_label"]) for e in evs]
          for name, _, evs in ours}
    merged = merge_maestro_ground_truth(gt)
    assert list(merged) == ["cafe_restaurant_01"]
    assert ours[1][0] == f"cafe_restaurant_01-{int(hop * 100):06d}-{int(hop * 100) + 1000:06d}"


@pytest.fixture(scope="module")
def prepared(tmp_path_factory):
    root = tmp_path_factory.mktemp("maestro")
    rng = np.random.default_rng(5)
    audio, anns = [], []
    for i, secs in enumerate((23, 31)):
        wav = root / f"city_center_{i:02d}.wav"
        write_wav(wav, (rng.standard_normal(44100 * secs) * 0.1).astype(np.float32), 44100)
        ann = root / f"city_center_{i:02d}.txt"
        ann.write_text("".join(f"{e['onset']}\t{e['offset']}\t{e['event_label']}\t"
                               f"{e['confidence']}\n" for e in _events(6 + i, 8, secs)))
        audio.append(wav)
        anns.append(ann)
    ours = m.prepare_maestro_folder(audio, anns, root / "ours", window_len=10, hop_len=5)
    theirs = jm.prepare_maestro_folder(audio, anns, root / "theirs", window_len=10, hop_len=5)
    return root, ours, theirs


def test_prepare_folder_table_matches_jax(prepared):
    _, ours, theirs = prepared
    assert tbl.columns(ours) == list(theirs.columns)
    assert tbl.n_rows(ours) == len(theirs) > 0
    for c in ("filename", "event_label"):
        assert list(ours[c]) == list(theirs[c]), c
    for c in ("onset", "offset", "confidence"):
        np.testing.assert_allclose(ours[c], theirs[c].to_numpy(), rtol=0, atol=TOL_SHIFTED)


def test_prepare_folder_chunks_match_jax(prepared):
    root, *_ = prepared
    names = sorted(p.name for p in (root / "theirs").glob("*.wav"))
    assert names == sorted(p.name for p in (root / "ours").glob("*.wav"))
    assert len(names) == 4 + 6  # 23 s: 0, 5, 10, then 15-23; 31 s: 0-20, then 25-31
    for n in names:
        a, fa = read_wav(root / "ours" / n)
        b, fb = read_wav(root / "theirs" / n)
        assert fa == fb == 16000 and a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0, atol=1.0 / 32768)


def test_prepare_folder_without_annotation(tmp_path):
    wav = tmp_path / "lone.wav"
    write_wav(wav, np.zeros(16000 * 12, np.float32), 16000)
    out = m.prepare_maestro_folder([wav], [], tmp_path / "chunks", window_len=10, hop_len=5)
    assert tbl.n_rows(out) == 0 and len(list((tmp_path / "chunks").glob("*.wav"))) == 2


@pytest.mark.parametrize("seed,split", [(42, 0.9), (1, 0.5), (7, 0.75)])
def test_split_maestro_dev_matches_jax(seed, split):
    files = [f"f{i:02d}.wav" for i in range(23)]
    scenes = [("cafe", "metro", "park")[i % 3] for i in range(23)]
    assert (m.split_maestro_dev(files, scenes, split, seed)
            == jm.split_maestro_dev(files, scenes, split, seed))
