"""Device-resident data stores (counterpart of desed_task_tpu/data/device_cache.py).

Train side (`DeviceResidentData`): when the corpus fits the card and needs
no per-epoch random crop (`fits_device_cache`), every slot's clips are
decoded once and kept on the card, audio as int16, labels float32,
embeddings in their own dtype. A train step then moves only its int64 row
indices [B] to the card and gathers its batch there (`batch_builder`); all
augmentation already runs in the step, so a gathered batch equals the
host-assembled one bit for bit (PCM16 sources round-trip int16 exactly).
Trade-off against the host path: a clip longer than pad_to would keep one
crop for the whole run, so such corpora stay on the host path.

Eval side (`DeviceEvalCache`): validation runs every epoch, student and
teacher, over the same clips. The cache decodes the set once and keeps its
audio and embeddings on the card, padded to whole batches, so that a
validation pass ships no audio and runs its forward as one loop over the
resident batches (training/evaluate.py). Filenames and labels stay on the
host for the metrics. Eval sets crop deterministically (test=True: left
crop), so caching is exact.

Both scale an item's float audio to int16 on a copy: the JAX package's
stores scale a float32 item's own array in place (device_cache.py:181-182
and :313 there); these leave the item as it was.

On a mesh (parallel.make_mesh), the eval stores are row-sharded over the
data axis as the JAX package's are (device_cache.py:279-292, :327-360):
each rank keeps only its block of whole batches on its card, and
training/evaluate.py gathers the scores to the axis's first rank. The train
store stays off under a mesh, as there (single_run.py:383).
"""

from __future__ import annotations

import time
from typing import Mapping

import numpy as np
import torch

from ..device import resolve_device
from ..obs.profiling import span

AUDIO_SCALE = 32768.0


def _to_int16(audio) -> np.ndarray:
    """float audio in [-1, 1) -> int16 samples, on a new array."""
    a = np.clip(np.asarray(audio, np.float32) * AUDIO_SCALE, -32768, 32767)
    return a.astype(np.int16)


def _to_device(arr: np.ndarray, device: torch.device, chunk_bytes: int) -> torch.Tensor:
    """Copy a host array to `device` in row chunks of about chunk_bytes."""
    out = torch.empty(arr.shape, dtype=torch.from_numpy(arr[:0]).dtype, device=device)
    rows = max(1, chunk_bytes // max(1, arr[:1].nbytes))
    for i in range(0, len(arr), rows):
        out[i : i + rows].copy_(torch.from_numpy(arr[i : i + rows]))
    return out


def wav_data_samples(path) -> int | None:
    """A clip's length in samples from its RIFF header alone (no data read);
    None for a file that needs a full parse."""
    import struct

    try:
        with open(path, "rb") as f:
            head = f.read(12)
            if len(head) < 12 or head[:4] != b"RIFF" or head[8:12] != b"WAVE":
                return None
            block_align = None
            while True:
                hdr = f.read(8)
                if len(hdr) < 8:
                    return None
                cid, size = hdr[:4], struct.unpack("<I", hdr[4:])[0]
                if cid == b"fmt ":
                    body = f.read(size + (size & 1))
                    block_align = struct.unpack_from("<HHIIHH", body, 0)[4]
                elif cid == b"data":
                    if block_align in (None, 0):
                        return None
                    return size // block_align
                else:
                    f.seek(size + (size & 1), 1)
    except OSError:
        return None


def fits_device_cache(datasets: Mapping[str, object], pad_to: int, max_bytes: int) -> bool:
    """True when every clip is <= pad_to samples (no per-epoch random crop to
    freeze) and the stores' estimated size (int16 audio, embeddings) fits
    max_bytes."""
    total = 0
    for ds in datasets.values():
        n = len(ds)
        examples = getattr(ds, "examples", None)
        names = getattr(ds, "examples_list", None)
        if n == 0 or examples is None or names is None:
            return False
        for name in names:
            ns = wav_data_samples(examples[name]["path"])
            if ns is None or ns > pad_to:
                return False
        total += n * pad_to * 2  # int16 audio
        emb = getattr(ds, "embeddings", None)
        if emb is not None:
            total += n * emb.get(next(iter(emb.index))).nbytes  # one row's probe
    return total <= max_bytes


class DeviceResidentData:
    """Flat per-field stores over the concatenation of all slots.

    `build()` decodes every slot's items once into host arrays; `upload()`
    copies them to `device` (default "cuda") in chunks and drops the host
    copies; `flat_index()` maps a step's per-slot indices to store rows;
    `batch_builder()` returns the gather that makes the step's batch on the
    device.
    """

    def __init__(self, slot_names, slot_sizes, stores_host, slot_offsets, masks,
                 has_embeddings, device: str | torch.device | None = None):
        self.device = resolve_device(device)
        self.slot_names = list(slot_names)
        self.slot_sizes = dict(slot_sizes)
        self.stores_host = stores_host  # {"audio": int16 [N, L], "labels", "embeddings"}
        self.slot_offsets = dict(slot_offsets)  # {slot: store row of its item 0}
        self.masks = dict(masks)  # {slot: bool [C]}
        self.has_embeddings = has_embeddings
        self.nbytes = sum(a.nbytes for a in stores_host.values())
        self.stores = None  # device tensors after upload()
        self.upload_seconds = None

    @classmethod
    def build(cls, datasets: Mapping[str, object], slot_names, num_workers: int = 4,
              verbose: bool = True, device: str | torch.device | None = None):
        from concurrent.futures import ThreadPoolExecutor

        slot_sizes = {s: len(datasets[s]) for s in slot_names}
        offsets, off = {}, 0
        for s in slot_names:
            offsets[s] = off
            off += slot_sizes[s]

        first = datasets[slot_names[0]][0]
        audio_len = first["audio"].shape[-1]
        label_shape = first["labels"].shape
        emb_in = [("embeddings" in datasets[s][0]) for s in slot_names]
        if any(emb_in) and not all(emb_in):
            raise ValueError("the device store needs embeddings on all slots or none")
        audio = np.zeros((off, audio_len), np.int16)
        labels = np.zeros((off, *label_shape), np.float32)
        emb = None
        if all(emb_in):
            e0 = np.asarray(first["embeddings"])
            emb = np.zeros((off, *e0.shape), e0.dtype)
        masks = {}

        def fill(slot, i):
            item = datasets[slot][i]
            g = offsets[slot] + i
            audio[g] = _to_int16(item["audio"])
            labels[g] = item["labels"]
            if emb is not None:
                emb[g] = item["embeddings"]
            return item.get("class_mask")

        for slot in slot_names:
            with ThreadPoolExecutor(max_workers=max(1, num_workers)) as pool:
                cm = list(pool.map(lambda i: fill(slot, i), range(slot_sizes[slot])))
            masks[slot] = (np.asarray(cm[0], bool) if cm and cm[0] is not None
                           else np.ones(label_shape[0], bool))
            if verbose:
                print(f"[device-cache] built slot {slot!r}: {slot_sizes[slot]} clips", flush=True)

        stores = {"audio": audio, "labels": labels}
        if emb is not None:
            stores["embeddings"] = emb
        return cls(slot_names, slot_sizes, stores, offsets, masks, emb is not None, device)

    def upload(self, chunk_bytes: int = 64 << 20, verbose: bool = True) -> dict:
        """Copy every store to the device in chunks of about chunk_bytes and
        drop the host copies; returns the device stores. The copies wait for
        the device: `upload_seconds` is their wall time."""
        t0 = time.perf_counter()
        self.stores = {}
        for name, arr in self.stores_host.items():
            self.stores[name] = _to_device(arr, self.device, chunk_bytes)
            if verbose:
                print(f"[device-cache] uploaded {name}: {arr.nbytes / 1e6:.0f} MB ({arr.dtype})",
                      flush=True)
        self.stores_host = None
        self.upload_seconds = time.perf_counter() - t0
        return self.stores

    def flat_index(self, idx_by_slot: Mapping[str, np.ndarray]) -> np.ndarray:
        """Per-slot local indices -> one int64 store-row vector in slot order
        (the order in which the train step concatenates the slots)."""
        return np.concatenate([np.asarray(idx_by_slot[s], np.int64) + self.slot_offsets[s]
                               for s in self.slot_names])

    def batch_builder(self, batch_sizes: Mapping[str, int]):
        """build(stores, flat_idx) -> the per-slot batch dict of the train
        step, every tensor on the device: audio float32, labels, embeddings
        in the store's dtype, class masks expanded from one row a slot.

        flat_idx: int64 [B] on the device, B the sum of the per-step slot
        sizes, concatenated in slot order (`flat_index`); with a leading
        micro-batch axis [A, B] every leaf gets that axis too."""
        names = self.slot_names
        sizes = [int(batch_sizes[s]) for s in names]
        masks = {s: torch.as_tensor(self.masks[s], device=self.device) for s in names}

        def build(stores, flat_idx):
            with span("store.gather"):
                axis = flat_idx.dim() - 1
                audio = stores["audio"][flat_idx].float() / AUDIO_SCALE
                labels = stores["labels"][flat_idx]
                emb = stores["embeddings"][flat_idx] if "embeddings" in stores else None
                batch, o = {}, 0
                for s, b in zip(names, sizes):
                    batch[s] = {
                        "audio": audio.narrow(axis, o, b),
                        "labels": labels.narrow(axis, o, b),
                        "class_mask": masks[s].expand(*flat_idx.shape[:-1], b, -1),
                    }
                    if emb is not None:
                        batch[s]["embeddings"] = emb.narrow(axis, o, b)
                    o += b
                return batch

        return build

    def index_to_device(self, flat_idx: np.ndarray) -> torch.Tensor:
        """A step's row indices on the device. On the card through pinned
        memory and a copy that does not wait, so that issuing a step waits
        on nothing."""
        with span("store.gather"):
            idx = torch.from_numpy(np.ascontiguousarray(flat_idx, np.int64))
            if self.device.type != "cuda":
                return idx.to(self.device)
            return idx.pin_memory().to(self.device, non_blocking=True)


class DeviceEvalCache:
    """Device-resident eval set for repeated validation and test passes.

    Decodes the dataset once; `upload()` puts audio [n_pad, N] int16 and
    embeddings [n_pad, ...] on `device` (default "cuda"), n_pad the length
    rounded up to whole batches (to batch_size * n_shards, so that a data
    axis of n_shards ranks can take equal blocks of whole batches), zero
    rows past the end. Sharded (`upload(mesh=...)`), a rank keeps rows
    [r n_pad / k, (r + 1) n_pad / k) of data index r of k.
    """

    def __init__(self, dataset, batch_size: int, num_workers: int = 4, n_shards: int = 1,
                 device: str | torch.device | None = None):
        from concurrent.futures import ThreadPoolExecutor

        self.device = resolve_device(device)
        self.batch_size = int(batch_size)
        n = len(dataset)
        first = dataset[0]
        audio_len = first["audio"].shape[-1]
        if first["audio"].ndim != 1:
            raise ValueError("eval cache supports mono [N] audio only")
        self.n = n
        chunk = self.batch_size * max(int(n_shards), 1)
        self.n_pad = -(-n // chunk) * chunk
        self.rows = self.n_pad  # resident rows on this rank
        self.mesh = self.mesh_axis = None
        self._audio = np.zeros((self.n_pad, audio_len), np.int16)
        self._emb = None
        if "embeddings" in first:
            e0 = np.asarray(first["embeddings"])
            self._emb = np.zeros((self.n_pad, *e0.shape), e0.dtype)
        self.labels = np.zeros((n, *first["labels"].shape), np.float32)
        self.filenames: list = [None] * n

        def fill(i):
            item = dataset[i]
            self._audio[i] = _to_int16(item["audio"])
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
        drop the host copies; returns {"audio", "embeddings"}. With a `mesh`
        whose `mesh_axis` has k > 1 ranks, only this rank's block of n_pad / k
        rows goes to its card (the cache must be built with n_shards=k)."""
        audio, emb = self._audio, self._emb
        if mesh is not None and mesh.shape[mesh_axis] > 1:
            k, r = mesh.shape[mesh_axis], mesh.index[mesh_axis]
            if self.n_pad % (self.batch_size * k):
                raise ValueError(f"n_pad={self.n_pad} does not split into {k} blocks of whole "
                                 f"batches of {self.batch_size}; build the cache with "
                                 f"n_shards={k}")
            self.rows = self.n_pad // k
            audio = audio[r * self.rows:(r + 1) * self.rows]
            emb = None if emb is None else emb[r * self.rows:(r + 1) * self.rows]
            self.mesh, self.mesh_axis = mesh, mesh_axis
        self.stores = {"audio": _to_device(audio, self.device, chunk_bytes),
                       "embeddings": None if emb is None else _to_device(emb, self.device,
                                                                         chunk_bytes)}
        self._audio = self._emb = None
        if verbose:
            shards = "" if self.mesh is None else f" (sharded x{mesh.shape[mesh_axis]})"
            print(f"[device-cache] eval upload{shards}: {self.nbytes / 1e6:.0f} MB", flush=True)
        return self.stores

    def batch(self, start: int):
        """(audio [bs, N] float32, embeddings [bs, ...] | None) of the resident
        rows start .. start + batch_size (rows of this rank's block when
        sharded), on the device."""
        audio = self.stores["audio"][start : start + self.batch_size].float() / AUDIO_SCALE
        emb = self.stores["embeddings"]
        return audio, None if emb is None else emb[start : start + self.batch_size]

    def batches(self):
        """Yield (audio, embeddings | None, n_real, filenames, labels) per
        batch; audio and embeddings are device tensors."""
        if self.stores is None:
            raise RuntimeError("call upload() first")
        if self.mesh is not None:
            raise RuntimeError("a sharded cache is predicted by training/evaluate.py's loop, "
                               "which gathers its scores; it has no host batches")
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
    stay host-side. With a `mesh`, the stores are row-sharded over its
    `mesh_axis` (its size, mesh.shape[mesh_axis], not the mesh's)."""
    n_shards = 1 if mesh is None else mesh.shape[mesh_axis]
    out = {}
    for name, ds in eval_sets.items():
        if ds is None or len(ds) == 0:
            out[name] = ds
            continue
        try:
            cache = DeviceEvalCache(ds, batch_size, n_shards=n_shards, device=device)
        except (ValueError, KeyError) as e:
            if verbose:
                print(f"[device-cache] eval {name!r} stays host-side: {e}", flush=True)
            out[name] = ds
            continue
        if cache.nbytes > max_bytes:
            out[name] = ds
            continue
        cache.upload(mesh=mesh, mesh_axis=mesh_axis)
        if verbose:
            print(f"[device-cache] eval {name!r}: {len(ds)} clips, "
                  f"{cache.nbytes / 1e6:.0f} MB on device", flush=True)
        out[name] = cache
    return out
