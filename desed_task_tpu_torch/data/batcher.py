"""Fixed-slot multi-source batching with background prefetch (counterpart of
desed_task_tpu/data/batcher.py; numpy and threads, no torch).

Emits per-slot numpy batches

    {slot_name: {"audio": [b, N], "labels": [b, C, T], "embeddings": ...,
                 "class_mask": [b, C]}}

which the train step concatenates in slot order (training/mean_teacher.py),
so the flat batch keeps the reference's [maestro | synth | strong | weak |
unlabeled] row order. As the reference sampler (desed_task/dataio/
sampler.py:5-88): each slot draws from its own shuffled permutation
(`np.random.default_rng(seed + i)` for slot i, so the streams equal the JAX
package's bit for bit); an epoch is min_i(len(dataset_i) // batch_size_i)
steps; a smaller dataset reshuffles and wraps across epochs.

`shard_index` / `num_shards` partition every slot's stream by stride.
`shuffle=False` takes each slot in index order (arange before the shard
slice), drawing nothing from the slot's generator.
Prefetch runs a thread pool (decoding is numpy and I/O) feeding a bounded
queue of ready batches.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Mapping, Sequence

import numpy as np


def collate(items: Sequence[Mapping[str, np.ndarray]]) -> dict:
    """Stack a list of per-item dicts into arrays (string fields listed)."""
    out = {}
    for key in items[0]:
        vals = [it[key] for it in items]
        if isinstance(vals[0], (str, bytes)):
            out[key] = list(vals)
        else:
            out[key] = np.stack([np.asarray(v) for v in vals])
    return out


class SlotSampler:
    """Infinite index stream over one dataset, shuffled unless `shuffle` is
    False (optionally sharded)."""

    def __init__(self, n: int, seed: int, shard_index=0, num_shards=1, shuffle: bool = True):
        self.n = n
        self.rng = np.random.default_rng(seed)
        self.shard_index = shard_index
        self.num_shards = num_shards
        self.shuffle = shuffle
        self._buf: list[int] = []

    def _refill(self):
        idx = self.rng.permutation(self.n) if self.shuffle else np.arange(self.n)
        self._buf.extend(idx[self.shard_index :: self.num_shards].tolist())

    def take(self, k: int) -> list[int]:
        while len(self._buf) < k:
            self._refill()
        out, self._buf = self._buf[:k], self._buf[k:]
        return out

    @property
    def shard_len(self) -> int:
        return len(range(self.shard_index, self.n, self.num_shards))


class MultiSourceBatcher:
    """Iterates fixed-slot batches over several datasets.

    datasets:    {slot_name: dataset} (items indexable, len()-able)
    batch_sizes: {slot_name: examples per step on this host}
    """

    def __init__(
        self,
        datasets: Mapping[str, object],
        batch_sizes: Mapping[str, int],
        seed: int = 42,
        shard_index: int = 0,
        num_shards: int = 1,
        num_workers: int = 6,
        prefetch: int = 4,
        shuffle: bool = True,
    ):
        if set(datasets) != set(batch_sizes):
            raise ValueError(f"slots {sorted(datasets)} but batch sizes for {sorted(batch_sizes)}")
        self.datasets = dict(datasets)
        self.batch_sizes = dict(batch_sizes)
        self.samplers = {
            name: SlotSampler(len(ds), seed + i, shard_index, num_shards, shuffle)
            for i, (name, ds) in enumerate(self.datasets.items())
        }
        self.num_workers = num_workers
        self.prefetch = prefetch

    @property
    def steps_per_epoch(self) -> int:
        """min over slots of shard-local examples // batch size (sampler.py:82-88)."""
        return min(self.samplers[n].shard_len // bs for n, bs in self.batch_sizes.items())

    def _build_batch(self, pool: ThreadPoolExecutor) -> dict:
        futures = {}
        for name, ds in self.datasets.items():
            idxs = self.samplers[name].take(self.batch_sizes[name])
            futures[name] = [pool.submit(ds.__getitem__, i) for i in idxs]
        return {name: collate([f.result() for f in futs]) for name, futs in futures.items()}

    def epoch(self, steps: int | None = None):
        """Yield `steps` (default steps_per_epoch) prefetched batches."""
        steps = steps if steps is not None else self.steps_per_epoch
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        failed = []

        def producer():
            try:
                with ThreadPoolExecutor(max_workers=max(1, self.num_workers)) as pool:
                    for _ in range(steps):
                        if stop.is_set():
                            return
                        q.put(self._build_batch(pool))
            except BaseException as e:  # handed to the consumer, which raises it
                failed.append(e)
            finally:
                q.put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            for _ in range(steps):
                batch = q.get()
                if batch is None:
                    break
                yield batch
            if failed:
                raise failed[0]
        finally:
            stop.set()
            # drain so that the producer can exit
            while t.is_alive() or not q.empty():
                try:
                    q.get(timeout=0.1)
                except queue.Empty:
                    pass

    def epoch_indices(self, steps: int | None = None):
        """Yield `steps` per-slot index batches {slot: int64 [bs]} without
        touching the datasets (the device-resident train store's path,
        data/device_cache.py). Draws from the same sampler streams as
        epoch(), so shuffling and epochs are those of the host path."""
        steps = steps if steps is not None else self.steps_per_epoch
        for _ in range(steps):
            yield {name: np.asarray(self.samplers[name].take(self.batch_sizes[name]), np.int64)
                   for name in self.datasets}

    def __iter__(self):
        return self.epoch()
