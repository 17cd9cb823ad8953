"""Offline pretrained-embedding extraction to HDF5 (counterpart of
desed_task_tpu/tools/embeddings.py).

Runs a frozen embedder (BEATs, PANNs or AST: models/{beats,panns,ast}.py)
over wav folders on the card and writes one HDF5 store a split with
  global_embeddings [N, D], frame_embeddings [N, D_f, T_f], filenames [N]
(`dtype="float16"` halves the store), the layout the datasets read
(data/datasets.py). The last batch is zero-padded to the batch size, so
every forward has one shape; wav decoding runs on host threads.

`build_embedder(name, checkpoint, device)` returns the module with its
weights on the device (default "cuda"): a released BEATs file or the port's
own pretraining output (training/beats_pretrain.py writes the released
layout with its BEATsConfig), a released PANNs Cnn14_16k or AST AudioSet
file, or, with no checkpoint, seeded random weights. `frame_embedder(model)`
turns an embedder into the `audio -> frame embeddings` callable that
InferencePipeline and make_train_step take.

h5py is imported inside the functions that write a store, and only when the
caller hands no module in its place (`h5py=`): the card's machine has none.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from ..device import resolve_device


def build_embedder(name: str, checkpoint: str | None = None,
                   device: str | torch.device | None = None) -> torch.nn.Module:
    """The embedder `name` (beats | panns | ast) in eval mode on `device`
    (default "cuda"), with the checkpoint's weights or, without one, seeded
    random weights (generator seed 0)."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(0)
    if name == "beats":
        from ..models.beats import BEATsModel, init_beats

        if checkpoint is not None and str(checkpoint).endswith(".msgpack"):
            raise ValueError(
                f"{checkpoint}: a JAX (flax msgpack) BEATs checkpoint needs flax to read; "
                "load its tree in the JAX package and convert it with "
                "models.convert.from_jax_embedder_params (from_jax_params for the "
                "embedders), or pass a torch file")
        if checkpoint is None:
            model = init_beats(BEATsModel(), gen)
        else:
            from ..models.convert import from_jax_embedder_params, load_beats_checkpoint

            cfg, tree = load_beats_checkpoint(checkpoint)
            model = BEATsModel(cfg)
            model.encoder.load_state_dict(from_jax_embedder_params(tree), strict=True)
    elif name == "panns":
        from ..models.panns import Cnn14_16k, init_panns

        model = Cnn14_16k()
        if checkpoint is None:
            init_panns(model, gen)
        else:
            from ..models.convert import from_jax_embedder_params, load_panns_checkpoint

            v = load_panns_checkpoint(checkpoint)
            model.load_state_dict(from_jax_embedder_params(v["params"], v["batch_stats"]),
                                  strict=True)
    elif name == "ast":
        from ..models.ast import ASTModel, init_ast

        model = ASTModel()
        if checkpoint is None:
            init_ast(model, gen)
        else:
            from ..models.convert import from_jax_embedder_params, load_ast_checkpoint

            model.load_state_dict(from_jax_embedder_params(load_ast_checkpoint(checkpoint)),
                                  strict=True)
    else:
        raise ValueError(f"unknown embedder {name!r} (beats|panns|ast)")
    for p in model.parameters():
        p.requires_grad_(False)
    return model.to(dev).eval()


def frame_embedder(model: torch.nn.Module):
    """audio [B, N] -> model(audio)["frame"] [B, E, T_e]."""

    def embed(audio: torch.Tensor) -> torch.Tensor:
        return model(audio)["frame"]

    return embed


def extract_folder(model: torch.nn.Module, wav_files: list, out_hdf5: str,
                   batch_size: int = 32, pad_to: int = 160000, num_workers: int = 6,
                   preprocess=None, dtype: str = "float32", watchdog=None, h5py=None,
                   device: str | torch.device | None = None) -> str:
    """Run the embedder over `wav_files` on `device` (default "cuda"; the
    model is moved there) and write the HDF5 store `out_hdf5`.

    dtype: the store's dtype ("float16" halves the store and the train-time
    reads). watchdog: the stall watchdog (default obs.watchdog's, 180 s).
    h5py: the module that writes the store (default: `import h5py`)."""
    from ..data.audio_io import read_audio
    from ..obs.watchdog import StallWatchdog

    if h5py is None:
        import h5py
    dev = resolve_device(device)
    model = model.to(dev).eval()
    wav_files = [str(f) for f in wav_files]
    if not wav_files:
        raise ValueError("no wav files to extract")
    wd = watchdog if watchdog is not None else StallWatchdog(timeout_s=180.0)

    @torch.inference_mode()
    def forward(audio: np.ndarray) -> dict:
        x = torch.as_tensor(audio, device=dev)
        return model(preprocess(x) if preprocess is not None else x)

    def load(path):
        return read_audio(path, pad_to=pad_to, test=True)[0]

    wd.start()
    wd.arm()
    try:
        _extract_loop(wd, forward, wav_files, out_hdf5, batch_size, pad_to, num_workers, dtype,
                      load, h5py)
    finally:
        wd.disarm()
        wd.stop()
    if wd.stalls:
        print(f"[extract] watchdog: {wd.stalls} stall(s), {wd.stalled_seconds:.0f}s stalled, "
              f"{wd.probes_launched} probe(s)", flush=True)
    return out_hdf5


def _extract_loop(wd, forward, wav_files, out_hdf5, batch_size, pad_to, num_workers, dtype,
                  load, h5py):
    first = forward(np.zeros((batch_size, pad_to), np.float32))
    g_dim = first["global"].shape[-1]
    f_shape = tuple(first["frame"].shape[1:])
    wd.beat()
    n = len(wav_files)
    with h5py.File(out_hdf5, "w") as f:
        g_ds = f.create_dataset("global_embeddings", (n, g_dim), dtype=dtype)
        f_ds = f.create_dataset("frame_embeddings", (n, *f_shape), dtype=dtype)
        names = f.create_dataset("filenames", (n,), dtype=h5py.string_dtype())
        with ThreadPoolExecutor(max_workers=num_workers) as pool:
            for start in range(0, n, batch_size):
                chunk = wav_files[start : start + batch_size]
                audio = np.stack(list(pool.map(load, chunk)))
                if len(chunk) < batch_size:  # pad the final batch: one shape throughout
                    audio = np.concatenate(
                        [audio, np.zeros((batch_size - len(chunk), pad_to), np.float32)])
                out = forward(audio)
                # numpy casts (round to nearest even), not the store's library
                for ds, key in ((g_ds, "global"), (f_ds, "frame")):
                    ds[start : start + len(chunk)] = (
                        out[key][: len(chunk)].cpu().numpy().astype(dtype))
                for i, path in enumerate(chunk):
                    names[start + i] = Path(path).stem
                wd.beat()


def extract_splits(embedder_name: str, checkpoint: str | None, split_folders: dict,
                   output_dir: str, fs: int = 16000, audio_len: float = 10.0,
                   batch_size: int = 32, dtype: str = "float32", h5py=None,
                   device: str | torch.device | None = None) -> dict:
    """Extract every split folder into output_dir/<embedder>/<split>.hdf5 on
    `device` (default "cuda"); a folder without wavs is skipped (said on a
    line). Returns {split: store path}."""
    dev = resolve_device(device)
    model = build_embedder(embedder_name, checkpoint, device=dev)
    preprocess = None
    if embedder_name == "ast":
        from ..ops.kaldi import ast_preprocess

        preprocess = ast_preprocess
    out_root = Path(output_dir) / embedder_name
    out_root.mkdir(parents=True, exist_ok=True)
    results = {}
    for split, folder in split_folders.items():
        wavs = sorted(Path(folder).glob("*.wav"))
        if not wavs:
            print(f"[extract] {split}: no wavs in {folder}, skipping")
            continue
        out = out_root / f"{split}.hdf5"
        print(f"[extract] {split}: {len(wavs)} files -> {out}")
        extract_folder(model, wavs, str(out), batch_size=batch_size, pad_to=int(audio_len * fs),
                       preprocess=preprocess, dtype=dtype, h5py=h5py, device=dev)
        results[split] = str(out)
    return results
