"""The port's embedding extraction (tools/embeddings.py, the extraction CLIs)
against desed_task_tpu/tools/embeddings.py on the CPU, with a tiny BEATs (1
layer, 32 wide) whose weights go to both sides (`from_jax_embedder_params`),
over 5 seeded one-second wavs at batch size 2, so the last batch is padded.

Tolerances: the HDF5 stores' embeddings within 1e-5 of max(1, max |JAX|)
(fp32, sums in another order), the filenames equal; a float16 store equal
to the float32 store's cast. `extract_splits` names its stores and skips an
empty folder as JAX's does (JAX's `build_embedder` cannot read a torch
BEATs file, see `test_reference_build_embedder_gap`, so both sides get the
same tiny module by monkeypatching their `build_embedder`). A CLI's
`main(argv)` on a tiny conf writes each existing split's store.
"""

import numpy as np
import pytest
import torch

import h5py
import jax
import jax.numpy as jnp

import desed_task_tpu.tools.embeddings as jemb
from desed_task_tpu.models.beats import BEATsConfig as JaxConfig
from desed_task_tpu.models.beats import BEATsModel as JaxBEATs
from desed_task_tpu_torch.data.audio_io import write_wav
from desed_task_tpu_torch.models import beats as tb
from desed_task_tpu_torch.models.convert import from_jax_embedder_params, to_reference_beats
from desed_task_tpu_torch.tools import embeddings as temb

TINY = dict(encoder_layers=1, encoder_embed_dim=32, embed_dim=16, encoder_ffn_embed_dim=32,
            encoder_attention_heads=2, conv_pos=8, conv_pos_groups=2, num_buckets=16,
            max_distance=32)
TOL = 1e-5


@pytest.fixture(scope="module")
def tiny():
    model = JaxBEATs(JaxConfig(**TINY))
    variables = model.init(jax.random.key(0), jnp.zeros((1, 16000), jnp.float32))
    r = np.random.default_rng(1)
    variables = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.05 * r.standard_normal(a.shape)).astype(np.float32),
        variables)
    port = tb.BEATsModel(tb.BEATsConfig(**TINY))
    port.load_state_dict(from_jax_embedder_params(variables["params"]), strict=True)
    return model, variables, port.eval()


def _wavs(folder, n, seed):
    folder.mkdir(parents=True, exist_ok=True)
    r = np.random.default_rng(seed)
    paths = []
    for i in range(n):
        p = folder / f"clip_{seed}_{i}.wav"
        write_wav(p, (r.standard_normal(16000) * 0.1).astype(np.float32), 16000)
        paths.append(p)
    return paths


def _read(path):
    with h5py.File(path, "r") as f:
        return {k: f[k][:] for k in ("global_embeddings", "frame_embeddings", "filenames")}


def _close(got, want, tol=TOL):
    return np.abs(got - want).max() / max(1.0, np.abs(want).max()) <= tol


def test_extract_folder_matches_jax(tiny, tmp_path):
    model, variables, port = tiny
    wavs = _wavs(tmp_path / "wavs", 5, 0)
    jemb.extract_folder(model, variables, wavs, str(tmp_path / "jax.hdf5"), batch_size=2,
                        pad_to=16000, num_workers=2)
    out = temb.extract_folder(port, wavs, str(tmp_path / "port.hdf5"), batch_size=2,
                              pad_to=16000, num_workers=2, device="cpu")
    got, want = _read(out), _read(tmp_path / "jax.hdf5")
    assert got["frame_embeddings"].shape == want["frame_embeddings"].shape == (5, 32, 48)
    assert got["global_embeddings"].shape == want["global_embeddings"].shape == (5, 32)
    assert got["frame_embeddings"].dtype == np.float32
    np.testing.assert_array_equal(got["filenames"], want["filenames"])
    assert [s.decode() for s in got["filenames"]] == [p.stem for p in wavs]
    for k in ("global_embeddings", "frame_embeddings"):
        assert _close(got[k], want[k]), k

    temb.extract_folder(port, wavs, str(tmp_path / "half.hdf5"), batch_size=2, pad_to=16000,
                        num_workers=2, dtype="float16", device="cpu")
    half = _read(tmp_path / "half.hdf5")
    for k in ("global_embeddings", "frame_embeddings"):
        assert half[k].dtype == np.float16
        np.testing.assert_array_equal(half[k], got[k].astype(np.float16))


def test_extract_folder_takes_an_h5py_stand_in(tiny, tmp_path):
    """The h5py seam: a module with File, create_dataset and string_dtype."""
    _, _, port = tiny
    wavs = _wavs(tmp_path / "wavs", 3, 2)
    made = {}

    class File(dict):
        def __init__(self, path, mode):
            super().__init__()
            made[path] = self

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def create_dataset(self, name, shape, dtype):
            self[name] = np.zeros(shape, object if dtype is str else dtype)
            return self[name]

    stand_in = type("H5", (), {"File": File, "string_dtype": staticmethod(lambda: str)})
    temb.extract_folder(port, wavs, "mem.hdf5", batch_size=2, pad_to=16000, h5py=stand_in,
                        device="cpu")
    ref = _read(temb.extract_folder(port, wavs, str(tmp_path / "ref.hdf5"), batch_size=2,
                                    pad_to=16000, device="cpu"))
    np.testing.assert_array_equal(made["mem.hdf5"]["frame_embeddings"], ref["frame_embeddings"])
    assert list(made["mem.hdf5"]["filenames"]) == [p.stem for p in wavs]


def test_extract_splits_names_and_skips_as_jax(tiny, tmp_path, monkeypatch):
    model, variables, port = tiny
    folders = {"synth_train": tmp_path / "synth", "weak_train": tmp_path / "weak",
               "devtest": tmp_path / "empty"}
    _wavs(folders["synth_train"], 3, 3)
    _wavs(folders["weak_train"], 2, 4)
    folders["devtest"].mkdir()
    monkeypatch.setattr(jemb, "build_embedder", lambda name, ckpt: (model, variables))
    monkeypatch.setattr(temb, "build_embedder", lambda name, ckpt, device: port)
    split_folders = {k: str(v) for k, v in folders.items()}
    want = jemb.extract_splits("beats", None, split_folders, str(tmp_path / "jax"), audio_len=1.0,
                               batch_size=2)
    got = temb.extract_splits("beats", None, split_folders, str(tmp_path / "port"),
                              audio_len=1.0, batch_size=2, device="cpu")
    assert set(got) == set(want) == {"synth_train", "weak_train"}
    for split in got:
        assert got[split].replace(str(tmp_path / "port"), "") == want[split].replace(
            str(tmp_path / "jax"), "")
        a, b = _read(got[split]), _read(want[split])
        np.testing.assert_array_equal(a["filenames"], b["filenames"])
        assert _close(a["frame_embeddings"], b["frame_embeddings"])


def test_reference_build_embedder_gap(tiny, tmp_path):
    """JAX's build_embedder("beats", <torch file>) calls .items() on the
    BEATsConfig that its load_beats_checkpoint returns; the port loads the
    same file (ROADMAP section 3)."""
    _, _, port = tiny
    path = tmp_path / "tiny.pt"
    torch.save({"cfg": dict(TINY), "model": to_reference_beats(
        port.encoder.state_dict(), TINY["encoder_layers"])}, path)
    with pytest.raises(AttributeError, match="items"):
        jemb.build_embedder("beats", str(path))
    loaded = temb.build_embedder("beats", str(path), device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(loaded.state_dict().values(),
                                                 port.state_dict().values()))
    assert not any(p.requires_grad for p in loaded.parameters())


def test_build_embedder_refuses_msgpack_and_unknown_names(tmp_path):
    with pytest.raises(ValueError, match="from_jax"):
        temb.build_embedder("beats", str(tmp_path / "enc.msgpack"), device="cpu")
    with pytest.raises(ValueError, match="unknown embedder"):
        temb.build_embedder("wav2vec", None, device="cpu")


def test_frame_embedder(tiny):
    _, _, port = tiny
    audio = torch.from_numpy((np.random.default_rng(5).standard_normal((2, 16000)) * 0.1)
                             .astype(np.float32))
    with torch.no_grad():
        np.testing.assert_array_equal(temb.frame_embedder(port)(audio).numpy(),
                                      port(audio)["frame"].numpy())


@pytest.mark.parametrize("year", [2022, 2023, 2024])
def test_extract_cli_main(tiny, tmp_path, year):
    import importlib

    import yaml

    _, _, port = tiny
    ckpt = tmp_path / "tiny.pt"
    torch.save({"cfg": dict(TINY), "model": to_reference_beats(
        port.encoder.state_dict(), TINY["encoder_layers"])}, ckpt)
    _wavs(tmp_path / "synth", 3, 6)
    _wavs(tmp_path / "weak", 2, 7)
    conf = tmp_path / "conf.yaml"
    conf.write_text(yaml.safe_dump({"data": {
        "fs": 16000, "audio_max_len": 1, "synth_folder": str(tmp_path / "synth"),
        "weak_folder": str(tmp_path / "weak"), "test_folder": str(tmp_path / "missing")}}))
    cli = importlib.import_module(f"desed_task_tpu_torch.recipes.dcase{year}_extract_embeddings")
    out = cli.main(["--conf_file", str(conf), "--checkpoint", str(ckpt), "--output_dir",
                    str(tmp_path / "emb"), "--batch_size", "2"], device="cpu")
    assert set(out) == {"synth_train", "weak_train"}
    assert _read(out["synth_train"])["frame_embeddings"].shape == (3, 32, 48)
    assert out["weak_train"] == str(tmp_path / "emb" / "beats" / "weak_train.hdf5")
    if year == 2022:
        with pytest.raises(SystemExit):
            cli.main([], device="cpu")  # no pretrained.yaml in 2022: --conf_file required
    else:
        assert cli.DEFAULT_CONF.is_file()


def test_extract_folder_arms_and_stops_the_watchdog(tiny, tmp_path):
    """The stall watchdog is started and armed around the loop, fed a beat
    after the warm-up forward and after every batch, then disarmed and
    stopped, also when a batch fails."""
    _, _, port = tiny
    wavs = _wavs(tmp_path / "wavs", 5, 8)
    calls = []
    wd = type("Stub", (), {n: (lambda n: lambda self: calls.append(n))(n)
                           for n in ("start", "arm", "beat", "disarm", "stop")})()
    wd.stalls = 0
    temb.extract_folder(port, wavs, str(tmp_path / "a.hdf5"), batch_size=2, pad_to=16000,
                        watchdog=wd, device="cpu")
    assert calls == ["start", "arm"] + ["beat"] * 4 + ["disarm", "stop"]
    calls.clear()
    with pytest.raises(FileNotFoundError):
        temb.extract_folder(port, [tmp_path / "missing.wav"], str(tmp_path / "b.hdf5"),
                            batch_size=2, pad_to=16000, watchdog=wd, device="cpu")
    assert calls[-2:] == ["disarm", "stop"]
