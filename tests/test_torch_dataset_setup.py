"""The port's dataset tools against the JAX package's, offline (after
tests/test_dataprep.py): the synthetic-tree links, the missing-file lists,
the audit of clips absent from disk, the duration tsv, the download helper
through a fake `requests` (no network), the staged setup through a fake
`desed`, and the 2022-2024 generate entry points, which run every stage
without `desed` or a network and say what to fetch by hand."""

import runpy
import sys
import types
import warnings
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

from desed_task_tpu.tools import dataset_setup as jsetup
from desed_task_tpu.tools import download as jdownload
from desed_task_tpu_torch.data.audio_io import write_wav
from desed_task_tpu_torch.tools import dataset_setup as setup
from desed_task_tpu_torch.tools import download
from desed_task_tpu_torch.utils import table as tbl

REPO = Path(__file__).resolve().parents[1]


def _synth_tree(root: Path, flat_validation: bool = True, with_eval: bool = False) -> Path:
    synth = root / "dcase_synth"
    for sub in ("soundscapes_16k", "extra"):
        (synth / "audio" / "train" / sub).mkdir(parents=True)
        (synth / "audio" / "train" / sub / "a.wav").write_bytes(b"x")
    val = synth / "audio" / "validation"
    (val if flat_validation else val / "synthetic21_validation").mkdir(parents=True)
    (val / "v.wav" if flat_validation
     else val / "synthetic21_validation" / "v.wav").write_bytes(b"x")
    splits = ["train", "validation"] + (["eval"] if with_eval else [])
    if with_eval:
        (synth / "audio" / "eval" / "soundscapes_16k").mkdir(parents=True)
    for split in splits:
        meta = synth / "metadata" / split / f"synthetic21_{split}"
        meta.mkdir(parents=True)
        (meta / "soundscapes.tsv").write_text("filename\tonset\n")
    return synth


def _links(dest: Path) -> list:
    return sorted(str(p.relative_to(dest)) for p in dest.rglob("*") if p.is_symlink())


@pytest.mark.parametrize("flat,with_eval", [(True, False), (False, False), (True, True)])
def test_link_synth_tree_matches_jax(tmp_path, flat, with_eval):
    synth = _synth_tree(tmp_path, flat, with_eval)
    n = setup.link_synth_tree(synth, tmp_path / "ours")
    jn = jsetup.link_synth_tree(synth, tmp_path / "theirs")
    assert n == jn > 0
    assert _links(tmp_path / "ours") == _links(tmp_path / "theirs")
    assert (tmp_path / "ours/audio/train/soundscapes_16k/a.wav").exists()
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        assert setup.link_synth_tree(synth, tmp_path / "ours") == 0
    assert len(rec) >= 1


@pytest.mark.parametrize("missing", [["Y1.wav", "Y2.wav"], [],
                                     {"filename": ["a.wav"], "event_labels": ["Dog"]}])
def test_record_missing_files_matches_jax(tmp_path, monkeypatch, missing):
    monkeypatch.chdir(tmp_path)
    ours = setup.record_missing_files(missing, "ours").read_text()
    theirs_in = pd.DataFrame(missing) if isinstance(missing, dict) else missing
    theirs = jsetup.record_missing_files(theirs_in, "theirs").read_text()
    assert ours == theirs


def _audio_folder(root: Path) -> Path:
    audio = root / "audio"
    audio.mkdir()
    for i, name in enumerate(("a.wav", "b.wav")):
        write_wav(audio / name, np.zeros(160 * (i + 1), np.float32), 16000)
    return audio


@pytest.mark.parametrize("rows", [
    {"filename": ["a.wav", "b.wav", "gone.wav", "gone.wav"],
     "event_labels": ["Dog", "Cat", "Speech", "Dog"]},
    {"filename": ["sub/a.wav", "x.wav", "y.wav", "x.wav"], "onset": [0.5, 1.0, 2.25, 3.0],
     "offset": [1.5, 2.0, 3.25, 4.0], "event_label": ["Dog", "Cat", "Dog", "Cat"]},
    {"filename": ["a.wav", "b.wav"], "event_labels": ["Dog", "Cat"]},
])
def test_audit_missing_files_matches_jax(tmp_path, rows):
    audio = _audio_folder(tmp_path)
    meta = tmp_path / "meta.tsv"
    pd.DataFrame(rows).to_csv(meta, sep="\t", index=False)
    ours = download.audit_missing_files(meta, audio, tmp_path / "ours.tsv")
    theirs = jdownload.audit_missing_files(meta, audio, tmp_path / "theirs.tsv")
    assert tbl.n_rows(ours) == len(theirs)
    for c in theirs.columns:
        assert list(ours[c]) == list(theirs[c])
    assert (tmp_path / "ours.tsv").exists() == (tmp_path / "theirs.tsv").exists()
    if len(theirs):
        pd.testing.assert_frame_equal(pd.read_csv(tmp_path / "ours.tsv", sep="\t"),
                                      pd.read_csv(tmp_path / "theirs.tsv", sep="\t"))


def test_generate_tsv_wav_durations_matches_jax(tmp_path):
    audio = _audio_folder(tmp_path)
    write_wav(audio / "c.wav", np.zeros((2, 441), np.float32), 44100)
    ours = download.generate_tsv_wav_durations(audio, tmp_path / "o" / "dur.tsv")
    theirs = jdownload.generate_tsv_wav_durations(audio, tmp_path / "t" / "dur.tsv")
    assert list(ours["filename"]) == list(theirs["filename"])
    np.testing.assert_array_equal(ours["duration"], theirs["duration"].to_numpy())
    assert (tmp_path / "o/dur.tsv").read_text() == (tmp_path / "t/dur.tsv").read_text()


class _Response:
    def __init__(self, chunks, status=200):
        self.chunks, self.status = chunks, status
        self.headers = {"content-length": str(sum(len(c) for c in chunks))}

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def raise_for_status(self):
        if self.status != 200:
            raise _RequestException(f"HTTP {self.status}")

    def iter_content(self, chunk_size):
        return iter(self.chunks)


class _RequestException(Exception):
    pass


@pytest.fixture
def fake_requests(monkeypatch):
    mod = types.ModuleType("requests")
    mod.RequestException = _RequestException
    calls = []

    def get(url, stream=False, timeout=None):
        calls.append(url)
        return _Response([b"abc", b"def"], 404 if "missing" in url else 200)

    mod.get = get
    monkeypatch.setitem(sys.modules, "requests", mod)
    return calls


def test_download_from_url_streams_to_disk(tmp_path, fake_requests, capsys):
    out = download.download_from_url("https://example.org/f.zip", tmp_path / "d" / "f.zip")
    assert Path(out).read_bytes() == b"abcdef" and fake_requests == ["https://example.org/f.zip"]
    assert "100.0%" in capsys.readouterr().out


def test_download_failure_says_what_to_do(tmp_path, fake_requests):
    with pytest.raises(RuntimeError, match="fetch the file manually"):
        download.download_from_url("https://example.org/missing.zip", tmp_path / "m.zip")


@pytest.fixture
def fake_desed(monkeypatch, tmp_path):
    """A `desed` whose archive download lays out a synthetic tree, whose
    AudioSet downloads miss one clip, and whose file download goes through
    the port's (patched) download_from_url: nothing touches a network."""
    desed = types.ModuleType("desed")
    calls = []

    def download_audioset_data(folder, n_jobs=1, chunk_size=10):
        calls.append(("real", folder))
        return ["Ymissing.wav"]

    def download_and_unpack_archive(url, folder, archive_format="zip"):
        calls.append(("synth", url))
        _synth_tree(tmp_path / "base" / "dcase" / "dataset")

    def download_file_from_url(url, dest):
        calls.append(("strong_tsv", url))
        download.download_from_url(url, dest)

    def download_audioset_files_from_csv(tsv, folder, missing_files_tsv=None):
        calls.append(("strong", tsv))

    desed.download_audioset_data = download_audioset_data
    desed.utils = types.SimpleNamespace(download_file_from_url=download_file_from_url)
    desed.download = types.SimpleNamespace(
        download_and_unpack_archive=download_and_unpack_archive,
        download_audioset_files_from_csv=download_audioset_files_from_csv)
    monkeypatch.setitem(sys.modules, "desed", desed)
    monkeypatch.setattr(download, "download_from_url",
                        lambda url, dest: Path(dest).parent.mkdir(parents=True, exist_ok=True)
                        or Path(dest).write_text("filename\n") or str(dest))
    return calls


def test_staged_setup_with_desed(tmp_path, monkeypatch, fake_desed):
    monkeypatch.chdir(tmp_path)
    with warnings.catch_warnings(record=True):
        warnings.simplefilter("always")
        folder = setup.generate_dcase_staged(str(tmp_path / "base"))
    assert [c[0] for c in fake_desed] == ["real", "strong_tsv", "strong", "synth"]
    assert (tmp_path / "missing_files" / "missing_files_desed_real.tsv").read_text() == (
        "filename\nYmissing.wav\n")
    assert (Path(folder) / "metadata/train/audioset_strong.tsv").is_file()
    assert (Path(folder) / "audio/train/soundscapes_16k").is_symlink()


@pytest.mark.parametrize("only", ["--only_real", "--only_synth", "--only_strong", None])
@pytest.mark.parametrize("year", ["2022", "2023"])
def test_generate_cli_degrades_like_jax(year, only, tmp_path, monkeypatch, capsys):
    import importlib

    cli = importlib.import_module(
        f"desed_task_tpu_torch.recipes.dcase{year}_generate_dcase_task4_{year}")
    monkeypatch.chdir(tmp_path)
    monkeypatch.setitem(sys.modules, "desed", None)  # not installed
    flags = [only] if only else []
    folder = cli.main(["--basedir", str(tmp_path), "--out_dir", str(tmp_path / "out"), *flags])
    ours = capsys.readouterr().out
    script = REPO / f"recipes/dcase{year}_task4_baseline/generate_dcase_task4_{year}.py"
    monkeypatch.setattr(sys, "argv", [str(script), "--basedir", str(tmp_path),
                                      "--out_dir", str(tmp_path / "out"), *flags])
    runpy.run_path(str(script), run_name="__main__")
    theirs = capsys.readouterr().out
    strip = lambda s: [line for line in s.splitlines() if not line.startswith("done in")]
    assert folder == str(tmp_path / "out")
    assert strip(ours) == [line.replace("desed_task_tpu.tools", "desed_task_tpu_torch.tools")
                           for line in strip(theirs)]


@pytest.mark.parametrize("stages", [["audit"], ["synth"], ["maestro"], ["real", "strong"]])
def test_generate_2024_cli_degrades_like_jax(stages, tmp_path, monkeypatch, capsys):
    from desed_task_tpu_torch.recipes import dcase2024_generate_dcase_task4_2024 as cli

    base = tmp_path / "dataset"
    (base / "metadata/train").mkdir(parents=True)
    (base / "audio/train/weak").mkdir(parents=True)
    write_wav(base / "audio/train/weak/a.wav", np.zeros(160, np.float32), 16000)
    pd.DataFrame({"filename": ["a.wav", "gone.wav"], "event_labels": ["Dog", "Cat"]}).to_csv(
        base / "metadata/train/weak.tsv", sep="\t", index=False)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setitem(sys.modules, "desed", None)
    cli.main(["--basedir", str(base), "--stage", *stages])
    ours = capsys.readouterr().out
    ours_files = {p.name: p.read_text() for p in (tmp_path / "missing_files").glob("*")}
    script = REPO / "recipes/dcase2024_task4_baseline/generate_dcase_task4_2024.py"
    monkeypatch.setattr(sys, "argv", [str(script), "--basedir", str(base), "--stage", *stages])
    runpy.run_path(str(script), run_name="__main__")
    assert ours == capsys.readouterr().out
    assert ours_files == {p.name: p.read_text() for p in (tmp_path / "missing_files").glob("*")}


def test_generate_2024_cli_synth_and_maestro_stages(tmp_path):
    from desed_task_tpu.data.maestro_prep import prepare_maestro_folder
    from desed_task_tpu_torch.recipes import dcase2024_generate_dcase_task4_2024 as cli

    rng = np.random.default_rng(0)
    bank = tmp_path / "bank"
    (bank / "foreground" / "Dog").mkdir(parents=True)
    (bank / "background").mkdir()
    write_wav(bank / "foreground/Dog/d.wav", (rng.standard_normal(16000) * 0.2).astype(
        np.float32), 16000)
    write_wav(bank / "background/b.wav", (rng.standard_normal(48000) * 0.02).astype(
        np.float32), 16000)
    m = tmp_path / "maestro"
    (m / "development_audio").mkdir(parents=True)
    (m / "development_annotation").mkdir(parents=True)
    write_wav(m / "development_audio/cafe_01.wav",
              (rng.standard_normal(16000 * 13) * 0.1).astype(np.float32), 16000)
    (m / "development_annotation/cafe_01.txt").write_text("1.0\t4.5\tcar\t0.75\n")
    base = tmp_path / "dataset"
    cli.main(["--basedir", str(base), "--soundbank", str(bank), "--maestro_dir", str(m),
              "--n_soundscapes", "2", "--stage", "synth", "maestro"])
    synth = base / "dcase_synth/audio/train/synthetic21_train/soundscapes_16k"
    assert len(list(synth.glob("*.wav"))) == 2
    ours = tbl.read_tsv(base / "metadata" / "maestro_real_train.tsv")
    theirs = prepare_maestro_folder([m / "development_audio/cafe_01.wav"],
                                    [m / "development_annotation/cafe_01.txt"],
                                    tmp_path / "jax_chunks", window_len=10, hop_len=1)
    assert list(ours["filename"]) == list(theirs["filename"])
    np.testing.assert_allclose(ours["onset"], theirs["onset"].to_numpy(), rtol=0, atol=1e-12)
