"""The port's soundscape tools against the JAX package's on seeded inputs:
tools/dsp.py (time stretch, pitch shift, BS.1770 loudness; within 1e-5),
the generator (the same metadata for the same seed, exactly, and the same
wavs within one PCM16 step), rerender_subset, the two 2021 generate entry
points against their JAX twins, and the quickstart: its soundbank and
corpus against examples/quickstart_synthetic.py's, and one epoch of it
through the port's single_run on the CPU."""

import importlib.util
import json
import runpy
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

from desed_task_tpu.tools import dsp as jdsp
from desed_task_tpu.tools.soundscapes import SoundscapeConfig as JaxConfig
from desed_task_tpu.tools.soundscapes import SoundscapeGenerator as JaxGenerator
from desed_task_tpu.tools.soundscapes import rerender_subset as jax_rerender
from desed_task_tpu_torch.data.audio_io import read_wav, write_wav
from desed_task_tpu_torch.tools import dsp
from desed_task_tpu_torch.tools.soundscapes import (SoundscapeConfig, SoundscapeGenerator,
                                                    rerender_subset)
from desed_task_tpu_torch.utils import table as tbl

REPO = Path(__file__).resolve().parents[1]
TOL_DSP = 1e-5
PCM_STEP = 1.0 / 32768


def _signal(seed, n=16000):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000
    return (0.3 * np.sin(2 * np.pi * 330 * t) + 0.05 * rng.standard_normal(n)).astype(np.float32)


@pytest.mark.parametrize("rate", [0.8, 1.0, 1.25])
def test_time_stretch_matches_jax(rate):
    x = _signal(1)
    ours, theirs = dsp.time_stretch(x, rate), jdsp.time_stretch(x, rate)
    assert ours.shape == theirs.shape
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=TOL_DSP)


@pytest.mark.parametrize("semitones", [-3.0, -1.2, 0.0, 2.5, 12.0])
def test_pitch_shift_matches_jax(semitones):
    x = _signal(2)
    ours, theirs = dsp.pitch_shift(x, semitones, 16000), jdsp.pitch_shift(x, semitones, 16000)
    assert ours.shape == theirs.shape == x.shape
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=TOL_DSP)


@pytest.mark.parametrize("fs", [16000, 44100])
def test_lufs_and_scaling_match_jax(fs):
    x = _signal(3, fs)
    assert abs(dsp.lufs(x, fs) - jdsp.lufs(x, fs)) <= TOL_DSP
    ours, theirs = dsp.scale_to_lufs(x, -30.0, fs), jdsp.scale_to_lufs(x, -30.0, fs)
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=TOL_DSP)
    assert abs(dsp.lufs(ours, fs) + 30.0) < 0.1
    assert dsp.lufs(np.zeros(fs, np.float32), fs) == jdsp.lufs(np.zeros(fs), fs) == -70.0


def _soundbank(root: Path) -> tuple[Path, Path]:
    """Two classes of seeded events (one at 44.1 kHz, resampled on load)
    and one background."""
    rng = np.random.default_rng(11)
    fg, bg = root / "fg", root / "bg"
    for cls in ("Dog", "Speech"):
        (fg / cls).mkdir(parents=True)
        for i in range(2):
            rate = 44100 if (cls, i) == ("Speech", 1) else 16000
            write_wav(fg / cls / f"{cls}_{i}.wav",
                      (rng.standard_normal(int(rate * (0.6 + 0.5 * i))) * 0.2).astype(np.float32),
                      rate)
    bg.mkdir()
    write_wav(bg / "bg0.wav", (rng.standard_normal(40000) * 0.05).astype(np.float32), 16000)
    return fg, bg


def _frames_equal(ours: dict, theirs: pd.DataFrame):
    assert tbl.columns(ours) == list(theirs.columns)
    for c in theirs.columns:
        a, b = tbl.column(ours, c), theirs[c].to_numpy()
        assert [tbl.is_missing(v) for v in a] == [tbl.is_missing(v) for v in b], c
        keep = [not tbl.is_missing(v) for v in b]
        assert list(a[keep]) == list(b[keep]), c


def _wavs_close(dir_a: Path, dir_b: Path):
    names = sorted(p.name for p in dir_b.glob("*.wav"))
    assert names and sorted(p.name for p in dir_a.glob("*.wav")) == names
    for n in names:
        a, fa = read_wav(dir_a / n)
        b, fb = read_wav(dir_b / n)
        assert fa == fb and a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0, atol=PCM_STEP)


@pytest.fixture(scope="module")
def generated(tmp_path_factory):
    root = tmp_path_factory.mktemp("soundscapes")
    fg, bg = _soundbank(root)
    kw = dict(duration=3.0, event_count_mean=3, max_events=4)
    ours = SoundscapeGenerator(fg, bg, SoundscapeConfig(**kw), seed=5)
    theirs = JaxGenerator(fg, bg, JaxConfig(**kw), seed=5)
    t_ours = ours.generate(5, root / "ours", root / "ours.tsv")
    t_theirs = theirs.generate(5, root / "theirs", root / "theirs.tsv")
    return root, fg, bg, kw, t_ours, t_theirs


def test_generator_metadata_equals_jax(generated):
    root, *_ = generated
    names = sorted(p.name for p in (root / "theirs").glob("*.json"))
    assert len(names) == 5
    n_events = 0
    for n in names:
        a = json.loads((root / "ours" / n).read_text())
        b = json.loads((root / "theirs" / n).read_text())
        assert a == b
        n_events += len(a["events"])
    assert n_events > 0


def test_generator_wavs_within_one_pcm_step(generated):
    root, *_ = generated
    _wavs_close(root / "ours", root / "theirs")


def test_generator_table_and_tsv_equal_jax(generated):
    root, *_, t_ours, t_theirs = generated
    _frames_equal(t_ours, t_theirs)
    assert (root / "ours.tsv").read_text() == (root / "theirs.tsv").read_text()


def test_generator_seed_gives_the_same_soundscapes(generated, tmp_path):
    root, fg, bg, kw, t_ours, _ = generated
    again = SoundscapeGenerator(fg, bg, SoundscapeConfig(**kw), seed=5)
    t2 = again.generate(5, tmp_path / "again", tmp_path / "again.tsv")
    _frames_equal(t2, pd.DataFrame(t_ours))
    for w in sorted((root / "ours").glob("*.wav")):
        assert np.array_equal(read_wav(w)[0], read_wav(tmp_path / "again" / w.name)[0])


def test_render_of_stored_metadata_is_the_wav(generated):
    root, fg, bg, kw, *_ = generated
    gen = SoundscapeGenerator(fg, bg, SoundscapeConfig(**kw))
    for mpath in sorted((root / "ours").glob("*.json")):
        mix, _ = gen.render(json.loads(mpath.read_text()))
        np.testing.assert_allclose(mix, read_wav(mpath.with_suffix(".wav"))[0], rtol=0,
                                   atol=PCM_STEP)


@pytest.mark.parametrize("how", [
    dict(db_decrease=12.0, target_labels=["Dog"]),
    dict(target_labels=["Dog"], drop_nontarget=True, keep_background=False),
    dict(keep_background=False),
])
def test_rerender_subset_matches_jax(generated, tmp_path, how):
    root, fg, bg, kw, *_ = generated
    bg_arg = bg if how.get("keep_background", True) else None
    ours = rerender_subset(root / "ours", fg, bg_arg, tmp_path / "a", tmp_path / "a.tsv",
                           cfg=SoundscapeConfig(**kw), **how)
    theirs = jax_rerender(root / "theirs", fg, bg_arg, tmp_path / "b", tmp_path / "b.tsv",
                          cfg=JaxConfig(**kw), **how)
    _frames_equal(ours, theirs)
    _wavs_close(tmp_path / "a", tmp_path / "b")
    if how.get("drop_nontarget"):
        assert set(tbl.labels(ours)) <= {"Dog"}


def _run_jax_script(monkeypatch, script: Path, argv: list):
    monkeypatch.setattr(sys, "argv", [str(script), *argv])
    runpy.run_path(str(script), run_name="__main__")


def _bank_layout(root: Path) -> Path:
    fg, bg = _soundbank(root / "src")
    bank = root / "bank"
    (bank / "foreground").parent.mkdir(parents=True, exist_ok=True)
    fg.rename(bank / "foreground")
    bg.rename(bank / "background")
    return bank


def test_generate_2021_cli_matches_jax(tmp_path, monkeypatch, capsys):
    from desed_task_tpu_torch.recipes import dcase2021_generate_dcase_task4_2021 as cli

    bank = _bank_layout(tmp_path)
    args = ["--soundbank", str(bank), "--n_train", "3", "--n_val", "2", "--seed", "9"]
    tables = cli.main(["--basedir", str(tmp_path / "ours"), *args])
    _run_jax_script(monkeypatch, REPO / "recipes/dcase2021_task4_baseline/"
                    "generate_dcase_task4_2021.py", ["--basedir", str(tmp_path / "theirs"), *args])
    assert "[real] `desed` unavailable" in capsys.readouterr().out
    for split in ("train", "validation"):
        rel = f"metadata/{split}/synthetic21_{split}/soundscapes.tsv"
        assert ((tmp_path / "ours" / rel).read_text()
                == (tmp_path / "theirs" / rel).read_text())
        _wavs_close(tmp_path / "ours" / f"audio/{split}/synthetic21_{split}/soundscapes_16k",
                    tmp_path / "theirs" / f"audio/{split}/synthetic21_{split}/soundscapes_16k")
    assert tbl.n_rows(tables["train"]) >= 3


def test_generate_2021_cli_without_a_soundbank(tmp_path, capsys):
    from desed_task_tpu_torch.recipes import dcase2021_generate_dcase_task4_2021 as cli

    assert cli.main(["--basedir", str(tmp_path)]) == {}
    assert "pass --soundbank" in capsys.readouterr().out


def test_generate_subset_cli_matches_jax(generated, tmp_path, monkeypatch):
    from desed_task_tpu_torch.recipes import dcase2021_generate_dcase_subset as cli

    root, fg, bg, *_ = generated
    bank = _bank_layout(tmp_path)
    src = tmp_path / "gen"
    SoundscapeGenerator(bank / "foreground", bank / "background",
                        SoundscapeConfig(duration=3.0), seed=2).generate(
        3, src, tmp_path / "gen.tsv")
    common = ["--meta_folder", str(src), "--soundbank", str(bank), "--db_decrease", "6",
              "--target_class", "Speech"]
    ours = cli.main([*common, "--out_audio", str(tmp_path / "a"),
                     "--out_tsv", str(tmp_path / "a.tsv")])
    _run_jax_script(monkeypatch, REPO / "recipes/dcase2021_task4_baseline/"
                    "generate_dcase_subset.py",
                    [*common, "--out_audio", str(tmp_path / "b"), "--out_tsv",
                     str(tmp_path / "b.tsv")])
    assert (tmp_path / "a.tsv").read_text() == (tmp_path / "b.tsv").read_text()
    _wavs_close(tmp_path / "a", tmp_path / "b")
    assert len(set(ours["filename"])) == 3


def _jax_quickstart():
    spec = importlib.util.spec_from_file_location(
        "jax_quickstart", REPO / "examples" / "quickstart_synthetic.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_corpus_matches_the_jax_example(tmp_path):
    from desed_task_tpu_torch.recipes import quickstart_synthetic as qs

    jq = _jax_quickstart()
    bank_a = qs.make_soundbank(tmp_path / "a", np.random.default_rng(0))
    bank_b = jq.make_soundbank(tmp_path / "b", np.random.default_rng(0))
    for w in sorted(bank_b.rglob("*.wav")):
        assert (bank_a / w.relative_to(bank_b)).read_bytes() == w.read_bytes()
    qs.generate_corpus(tmp_path / "a", bank_a, 8)
    jq.generate_corpus(tmp_path / "b", bank_b, 8)
    for t in sorted((tmp_path / "b" / "meta").glob("*.tsv")):
        ours = tbl.read_tsv(tmp_path / "a" / "meta" / t.name)
        _frames_equal(ours, pd.read_csv(t, sep="\t"))
    for split in ("synth", "synth_val", "test", "weak", "unlab"):
        _wavs_close(tmp_path / "a" / "audio" / split, tmp_path / "b" / "audio" / split)


@pytest.fixture(scope="module")
def quickstart(tmp_path_factory):
    import torch

    from desed_task_tpu_torch.recipes import quickstart_synthetic as qs

    torch.set_num_threads(2)
    work = tmp_path_factory.mktemp("quickstart")
    info = {}
    state, results = qs.main(["--workdir", str(work), "--n_train", "32", "--epochs", "1"],
                             device="cpu", training={"device_watts": 50.0, "num_workers": 0},
                             run_info=info)
    return work, state, results, info


def test_quickstart_trains_one_epoch_on_the_cpu(quickstart):
    work, state, results, info = quickstart
    hist = info["loop"].history
    assert [h["epoch"] for h in hist] == [0] and hist[0]["busy_s"] > 0.0
    assert state.step >= 1
    assert all(np.isfinite(v) and 0.0 <= v <= 1.0 for v in results.values()
               if isinstance(v, float))
    assert (work / "exp" / "checkpoints" / "last").is_file()
    assert (work / "meta" / "weak.tsv").is_file()


def test_quickstart_needs_a_card_by_default(tmp_path, monkeypatch):
    import torch

    from desed_task_tpu_torch.recipes import quickstart_synthetic as qs

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        qs.main(["--workdir", str(tmp_path / "none")])
    assert not (tmp_path / "none").exists()
