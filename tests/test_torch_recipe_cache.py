"""The device-resident train store of the port (data/device_cache.py) on the
CPU: `wav_data_samples` and `fits_device_cache` against JAX's; the gather
of `DeviceResidentData(device="cpu")` bitwise equal to host `collate` and
to JAX's gather; a cached train step bitwise equal to the host-batch step
(with dropout and mixup on, the same generator seed); the item's float32
audio unchanged by `build` (JAX's store scales it in place); accumulation
through the store."""

import copy
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from desed_task_tpu.data import device_cache as jdc
from desed_task_tpu_torch.data import device_cache as tdc
from desed_task_tpu_torch.data.audio_io import write_wav
from desed_task_tpu_torch.data.batcher import MultiSourceBatcher, collate
from desed_task_tpu_torch.training import create_state, make_optimizer, make_train_step
from desed_task_tpu_torch.training import single_run as tsr

sys.path.insert(0, str(Path(__file__).parent))
from _torch_recipe_corpus import config_2024, write_corpus, write_embeddings  # noqa: E402


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = write_corpus(tmp_path_factory.mktemp("recipe_cache"))
    config = write_embeddings(root, config_2024(root))
    enc = tsr.build_encoder(config)
    datasets, sizes, slots = tsr.build_train_datasets(config, enc)
    for k in ("_weak_val", "_maestro_val_tsv"):
        datasets.pop(k, None)
    return root, config, datasets, sizes, slots


def test_wav_data_samples_matches_jax(corpus, tmp_path):
    root = corpus[0]
    paths = sorted((root / "maestro").glob("*.wav"))[:3] + sorted((root / "weak").glob("*.wav"))
    write_wav(tmp_path / "odd.wav", np.zeros(12345, np.float32), 16000)
    (tmp_path / "not_a.wav").write_bytes(b"RIFX0000WAVEfmt ")
    paths += [tmp_path / "odd.wav", tmp_path / "not_a.wav", tmp_path / "missing.wav"]
    for p in paths:
        assert tdc.wav_data_samples(p) == jdc.wav_data_samples(p), p
    assert tdc.wav_data_samples(tmp_path / "odd.wav") == 12345


@pytest.mark.parametrize("budget", [0, 1 << 20, 8 << 30])
@pytest.mark.parametrize("pad", [16000, 32000])
def test_fits_device_cache_matches_jax(corpus, budget, pad):
    datasets = corpus[2]
    assert tdc.fits_device_cache(datasets, pad, budget) == jdc.fits_device_cache(
        datasets, pad, budget)


@pytest.fixture(scope="module")
def store(corpus):
    _, _, datasets, sizes, slots = corpus
    names = [s.name for s in slots]
    cache = tdc.DeviceResidentData.build(datasets, names, num_workers=2, verbose=False,
                                         device="cpu")
    cache.upload(verbose=False)
    return cache


def _host_batch(datasets, idx_by_slot):
    return {s: collate([datasets[s][int(i)] for i in idx]) for s, idx in idx_by_slot.items()}


def test_gather_equals_host_collate_and_jax(corpus, store):
    _, _, datasets, sizes, slots = corpus
    names = [s.name for s in slots]
    assert store.stores["embeddings"].dtype == torch.float16
    assert store.stores["audio"].dtype == torch.int16
    build = store.batch_builder(sizes)
    jcache = jdc.DeviceResidentData.build(datasets, names, num_workers=2, verbose=False)
    jcache.upload(verbose=False)
    jbuild = jcache.batch_builder(sizes)
    batcher = MultiSourceBatcher(datasets, sizes, seed=3, num_workers=1)
    for idx in batcher.epoch_indices():
        flat = store.flat_index(idx)
        np.testing.assert_array_equal(flat, jcache.flat_index(idx))
        got = build(store.stores, store.index_to_device(flat))
        want_j = jbuild(jcache.stores, jnp.asarray(jcache.flat_index(idx)))
        host = _host_batch(datasets, idx)
        for s in names:
            for k in ("audio", "labels", "embeddings", "class_mask"):
                g = got[s][k].numpy()
                np.testing.assert_array_equal(g, np.asarray(want_j[s][k]), err_msg=f"{s} {k}")
                np.testing.assert_array_equal(g, host[s][k], err_msg=f"{s} {k}")
                assert g.dtype == host[s][k].dtype, (s, k)


def test_build_leaves_float_audio_as_it_was():
    """The store scales a float32 item's audio to int16 on a copy."""
    rng = np.random.default_rng(0)
    audio = [rng.uniform(-1, 1, 64).astype(np.float32) for _ in range(3)]
    kept = [a.copy() for a in audio]

    class Items:
        def __len__(self):
            return 3

        def __getitem__(self, i):
            return {"audio": audio[i], "labels": np.zeros((2, 4), np.float32)}

    cache = tdc.DeviceResidentData.build({"a": Items()}, ["a"], verbose=False, device="cpu")
    for a, k in zip(audio, kept):
        np.testing.assert_array_equal(a, k)
    want = np.clip(np.stack(kept) * 32768.0, -32768, 32767).astype(np.int16)
    np.testing.assert_array_equal(cache.stores_host["audio"], want)


def _state(config, slots, steps=4):
    torch.manual_seed(0)
    model = tsr.build_model(config)
    cfg = tsr.mean_teacher_config(config, slots, steps)
    opt, sched = make_optimizer(1e-3, cfg.rampup_steps)
    return cfg, opt, sched, create_state(model, cfg, opt, device="cpu")


@pytest.mark.parametrize("accumulate", [1, 2])
def test_cached_step_equals_host_step(corpus, store, accumulate):
    """Mixup (prob 1), dropout and dropstep on: the store's batch and the
    host batch of the same rows give bitwise-equal metrics and weights from
    the same state and generator seed."""
    _, config, datasets, sizes, slots = corpus
    config = copy.deepcopy(config)
    config["training"]["mixup_prob"] = 1.0
    cfg, opt, sched, st_a = _state(config, slots)
    st_b = copy.deepcopy(st_a)
    step = make_train_step(cfg, opt, sched, mel_cfg=tsr.mel_config(config),
                           accumulate=accumulate)
    build = store.batch_builder(sizes)
    batcher = MultiSourceBatcher(datasets, sizes, seed=4, num_workers=1)
    it = batcher.epoch_indices(steps=accumulate)
    idx = [next(it) for _ in range(accumulate)]
    flat = [store.flat_index(i) for i in idx]
    hosts = [_host_batch(datasets, i) for i in idx]
    if accumulate == 1:
        cached_batch = build(store.stores, store.index_to_device(flat[0]))
        host_batch = hosts[0]
    else:
        cached_batch = build(store.stores, store.index_to_device(np.stack(flat)))
        host_batch = {s: {k: np.stack([h[s][k] for h in hosts]) for k in hosts[0][s]}
                      for s in hosts[0]}
        assert cached_batch["weak"]["audio"].shape[0] == accumulate
    for _ in range(2):
        m_a = step(st_a, cached_batch, torch.Generator().manual_seed(9))
        m_b = step(st_b, host_batch, torch.Generator().manual_seed(9))
        for k in m_a:
            assert torch.equal(torch.as_tensor(m_a[k]), torch.as_tensor(m_b[k])), k
    for who in ("student", "teacher"):
        a, b = getattr(st_a, who).state_dict(), getattr(st_b, who).state_dict()
        for k in a:
            assert torch.equal(a[k], b[k]), (who, k)
