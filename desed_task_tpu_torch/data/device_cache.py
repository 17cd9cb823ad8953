"""Device-resident eval set (the eval side of desed_task_tpu/data/device_cache.py).

Validation runs every epoch, student and teacher, over the same clips. The
cache decodes the set once and keeps its audio (int16) and its embeddings
(in their own dtype) on the card, padded to whole batches, so that a
validation pass ships no audio and runs its forward as one loop over the
resident batches (training/evaluate.py). Filenames and labels stay on the
host for the metrics.

Eval sets crop deterministically (test=True: left crop), so caching is
exact; int16 storage round-trips PCM16 sources bit-exactly and bounds the
error of float sources at 2^-16 full scale.

One device only: the mesh arguments raise NotImplementedError (the sharded
eval of the JAX package is a later slice of the port).
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device

AUDIO_SCALE = 32768.0


def _to_device(arr: np.ndarray, device: torch.device, chunk_bytes: int) -> torch.Tensor:
    """Copy a host array to `device` in row chunks of about chunk_bytes."""
    out = torch.empty(arr.shape, dtype=torch.from_numpy(arr[:0]).dtype, device=device)
    rows = max(1, chunk_bytes // max(1, arr[:1].nbytes))
    for i in range(0, len(arr), rows):
        out[i : i + rows].copy_(torch.from_numpy(arr[i : i + rows]))
    return out


def _refuse_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError("the port's eval cache lives on one device")


class DeviceEvalCache:
    """Device-resident eval set for repeated validation and test passes.

    Decodes the dataset once; `upload()` puts audio [n_pad, N] int16 and
    embeddings [n_pad, ...] on `device` (default "cuda"), n_pad the length
    rounded up to whole batches, zero rows past the end.
    """

    def __init__(self, dataset, batch_size: int, num_workers: int = 4, n_shards: int = 1,
                 device: str | torch.device | None = None):
        from concurrent.futures import ThreadPoolExecutor

        if n_shards != 1:
            raise NotImplementedError("the port's eval cache lives on one device")
        self.device = resolve_device(device)
        self.batch_size = int(batch_size)
        n = len(dataset)
        first = dataset[0]
        audio_len = first["audio"].shape[-1]
        if first["audio"].ndim != 1:
            raise ValueError("eval cache supports mono [N] audio only")
        self.n = n
        self.n_pad = -(-n // self.batch_size) * self.batch_size
        self._audio = np.zeros((self.n_pad, audio_len), np.int16)
        self._emb = None
        if "embeddings" in first:
            e0 = np.asarray(first["embeddings"])
            self._emb = np.zeros((self.n_pad, *e0.shape), e0.dtype)
        self.labels = np.zeros((n, *first["labels"].shape), np.float32)
        self.filenames: list = [None] * n

        def fill(i):
            item = dataset[i]
            # a new array: the JAX cache scales a float32 item's audio in
            # place (device_cache.py:313); this one leaves the item as it was
            a = np.clip(np.asarray(item["audio"], np.float32) * AUDIO_SCALE, -32768, 32767)
            self._audio[i] = a.astype(np.int16)
            if self._emb is not None:
                self._emb[i] = item["embeddings"]
            self.labels[i] = item["labels"]
            self.filenames[i] = item.get("filename", f"clip_{i}")

        with ThreadPoolExecutor(max_workers=max(1, num_workers)) as pool:
            list(pool.map(fill, range(n)))
        self.nbytes = self._audio.nbytes + (self._emb.nbytes if self._emb is not None else 0)
        self.stores = None

    def __len__(self):
        return self.n

    def upload(self, chunk_bytes: int = 64 << 20, verbose: bool = False, mesh=None,
               mesh_axis: str = "data"):
        """Copy the stores to the device (in chunks of about chunk_bytes) and
        drop the host copies; returns {"audio", "embeddings"}."""
        del mesh_axis
        _refuse_mesh(mesh)
        emb = None if self._emb is None else _to_device(self._emb, self.device, chunk_bytes)
        self.stores = {"audio": _to_device(self._audio, self.device, chunk_bytes),
                       "embeddings": emb}
        self._audio = self._emb = None
        if verbose:
            print(f"[device-cache] eval upload: {self.nbytes / 1e6:.0f} MB", flush=True)
        return self.stores

    def batch(self, start: int):
        """(audio [bs, N] float32, embeddings [bs, ...] | None) of the resident
        rows start .. start + batch_size, on the device."""
        audio = self.stores["audio"][start : start + self.batch_size].float() / AUDIO_SCALE
        emb = self.stores["embeddings"]
        return audio, None if emb is None else emb[start : start + self.batch_size]

    def batches(self):
        """Yield (audio, embeddings | None, n_real, filenames, labels) per
        batch; audio and embeddings are device tensors."""
        if self.stores is None:
            raise RuntimeError("call upload() first")
        for start in range(0, self.n, self.batch_size):
            n_real = min(self.batch_size, self.n - start)
            audio, emb = self.batch(start)
            yield (audio, emb, n_real, self.filenames[start : start + n_real],
                   self.labels[start : start + n_real])


def build_eval_caches(eval_sets, batch_size: int, max_bytes: int = 2 << 30,
                      verbose: bool = True, mesh=None, mesh_axis: str = "data",
                      device: str | torch.device | None = None) -> dict:
    """DeviceEvalCache wrappers for eval datasets on `device` (default
    "cuda"). None and empty sets pass through; oversize or incompatible sets
    stay host-side."""
    del mesh_axis
    _refuse_mesh(mesh)
    out = {}
    for name, ds in eval_sets.items():
        if ds is None or len(ds) == 0:
            out[name] = ds
            continue
        try:
            cache = DeviceEvalCache(ds, batch_size, device=device)
        except (ValueError, KeyError) as e:
            if verbose:
                print(f"[device-cache] eval {name!r} stays host-side: {e}", flush=True)
            out[name] = ds
            continue
        if cache.nbytes > max_bytes:
            out[name] = ds
            continue
        cache.upload()
        if verbose:
            print(f"[device-cache] eval {name!r}: {len(ds)} clips, "
                  f"{cache.nbytes / 1e6:.0f} MB on device", flush=True)
        out[name] = cache
    return out
