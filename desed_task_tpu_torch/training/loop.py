"""The train loop: epochs, validation cadence, checkpoints, early stopping
(counterpart of desed_task_tpu/training/loop.py).

Replaces the pl.Trainer wiring of the reference (train_pretrained.py:
560-581: EarlyStopping and ModelCheckpoint on val/obj_metric, validation
every N epochs, gradient accumulation) with an explicit loop around the
mean-teacher step, which updates the state in place:
`step_fn(state, batch, generator) -> metrics`.

PyTorch issues the card's work asynchronously. One fetch a step (the
first metric, or all metrics in one copy on a logging step) keeps the host
from running ahead without bound; it is the loop's only host
synchronisation in a step, and it brackets each step's device work for the
energy model's busy time.

On a mesh (`mesh=`, as the JAX loop's loop.py:39, :57, :75-76), every rank
runs the loop: each host batch, the same global batch on every rank, is cut
to the rank's rows (parallel.shard_batch) before the step. The first rank
alone logs and writes checkpoints (each holding every rank's generator
state, gathered over the whole mesh in global rank order, whatever axes it
has), and every rank waits at a barrier of the whole mesh until a
checkpoint is written; every rank reads its own state back on resume.
Validation runs on every rank (the sharded eval gathers its scores to the
first, and hands its objective to all), so every rank takes the same
early-stopping decision.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..obs.checkpoint import CheckpointManager
from ..obs.energy import EnergyTracker
from ..obs.logging import MetricsLogger
from ..obs.watchdog import StallWatchdog
from ..parallel.mesh import shard_batch


def fetch_metrics(metrics: dict) -> dict:
    """The metrics as floats, with one copy from the card for all of them."""
    dev = {k: v for k, v in metrics.items() if isinstance(v, torch.Tensor) and v.is_cuda}
    out = {k: float(v) for k, v in metrics.items() if k not in dev}
    if dev:
        vals = torch.stack([v.float().reshape(()) for v in dev.values()]).cpu().tolist()
        out.update(zip(dev, vals))
    return {k: out[k] for k in metrics}


def _stack(group: list) -> dict:
    """Batches of one accumulation group stacked on a new leading axis."""
    return {slot: {k: np.stack([b[slot][k] for b in group]) for k in group[0][slot]}
            for slot in group[0]}


class TrainLoop:
    def __init__(
        self,
        step_fn: Callable,  # (state, batch, generator) -> metrics; state in place
        state,
        batcher,  # data.batcher.MultiSourceBatcher
        n_epochs: int,
        logger: Optional[MetricsLogger],  # None: nothing logged (a rank other than the first)
        ckpt: Optional[CheckpointManager] = None,
        validate_fn: Optional[Callable] = None,  # (state, epoch) -> (obj, scalars)
        validation_interval: int = 10,
        early_stop_patience: Optional[int] = None,
        rng: Optional[torch.Generator] = None,
        log_every: int = 50,
        energy: Optional[EnergyTracker] = None,
        accumulate_batches: int = 1,
        index_cache=None,  # data.device_cache.DeviceResidentData (uploaded)
        watchdog: Optional[StallWatchdog] = None,
        checkpoint_interval: Optional[int] = None,
        mesh=None,  # parallel.Mesh: batches sharded over its "data" axis
    ):
        self.step_fn = step_fn
        self.state = state
        self.batcher = batcher
        self.n_epochs = n_epochs
        self.logger = logger
        self.ckpt = ckpt
        self.validate_fn = validate_fn
        self.validation_interval = validation_interval
        self.early_stop_patience = early_stop_patience
        if rng is None:
            dev = next(state.student.parameters()).device
            rng = torch.Generator(device=dev).manual_seed(0)
        # the step's generator: its state goes into every checkpoint
        self.rng = rng
        self.log_every = log_every
        self.energy = energy
        self.accumulate_batches = accumulate_batches
        self.index_cache = index_cache
        self.watchdog = watchdog
        # the "last" checkpoint's cadence in epochs; None: the validation
        # cadence (the reference's ModelCheckpoint fires on validation), or
        # every epoch without validation
        self.checkpoint_interval = checkpoint_interval
        self.mesh = mesh
        self.rank = 0 if mesh is None else dist.get_rank()
        self.best_obj = -np.inf
        self.epochs_since_best = 0
        self.start_epoch = 0
        # per epoch run: {"epoch", "steps", "seconds", "busy_s", "val_s"}
        self.history: list[dict] = []

    def _batches(self):
        """Yield step batches: host batches from the batcher, or, with the
        device store, each step's row indices as one small tensor on the
        device. With accumulation, groups of `accumulate_batches` consecutive
        batches stacked on a new leading axis; the incomplete tail group is
        dropped, as the reference's epoch length
        len(ds) // (batch_size * accumulate_batches) (train_pretrained.py:457-466)."""
        acc = self.accumulate_batches
        cache = self.index_cache
        if cache is not None:
            group = []
            for idx in self.batcher.epoch_indices():
                group.append(cache.flat_index(idx))
                if len(group) == acc:
                    yield cache.index_to_device(group[0] if acc == 1 else np.stack(group))
                    group = []
            return
        group = []
        for batch in self.batcher.epoch():
            group.append(batch)
            if len(group) == acc:
                batch = batch if acc == 1 else _stack(group)
                yield (batch if self.mesh is None else
                       shard_batch(batch, self.mesh, batch_axis=0 if acc == 1 else 1))
                group = []

    def _log(self, step: int, scalars: dict):
        if self.logger is not None:
            self.logger.log_scalars(step, scalars)

    def _save(self, name: str, meta: dict, obj=None):
        """Checkpoint `name` (or "best" by `obj`); on a mesh every rank
        calls it, the first writes it with every rank's generator state, in
        global rank order (a model axis's ranks draw from generators of their
        own too)."""
        ranks = None
        if self.mesh is not None:
            group = self.mesh.cpu_world
            ranks = [None] * dist.get_world_size(group)
            dist.all_gather_object(ranks, self.rng.get_state(), group=group)
        if self.rank == 0:
            if obj is None:
                self.ckpt.save(self.state, meta, name=name, generator=self.rng,
                               rank_generators=ranks)
            else:
                self.ckpt.save_if_best(self.state, obj, meta, generator=self.rng,
                                       rank_generators=ranks)
        if self.mesh is not None:
            dist.barrier(group=self.mesh.cpu_world)

    def resume(self, name: str = "last") -> bool:
        """Restore the state, the generator and the loop's counters from a
        checkpoint, if there is one (on a mesh: on every rank, each its own
        generator state)."""
        if self.ckpt is not None and self.ckpt.exists(name):
            self.ckpt.restore(name, self.state, generator=self.rng,
                              rank=None if self.mesh is None else self.rank)
            meta = self.ckpt.metadata(name)
            self.start_epoch = int(meta.get("epoch", -1)) + 1
            self.best_obj = float(meta.get("best_obj", -np.inf))
            return True
        return False

    def run(self):
        if self.energy:
            self.energy.start()
        wd = self.watchdog
        if wd is not None:
            wd.start()
        step_count = 0
        for epoch in range(self.start_epoch, self.n_epochs):
            t0 = time.monotonic()
            step_busy = 0.0
            if wd is not None:
                # armed only while steps are issued: validation and test have
                # no regular heartbeat
                wd.arm()
            for batch in self._batches():
                ts = time.monotonic()
                metrics = self.step_fn(self.state, batch, self.rng)
                step_count += 1
                if step_count % self.log_every == 0:
                    host = fetch_metrics(metrics)
                    self._log(step_count, {f"train/{k}": v for k, v in host.items()})
                else:
                    # one scalar fetch a step bounds how far the host runs ahead
                    float(next(iter(metrics.values())))
                # the fetch makes issue -> fetch bracket the step's device work
                step_busy += time.monotonic() - ts
                if wd is not None:
                    wd.beat()
            if wd is not None:
                wd.disarm()
            dt = time.monotonic() - t0
            if self.energy:
                self.energy.record_busy(step_busy)
            steps = max(self.batcher.steps_per_epoch // self.accumulate_batches, 1)
            self._log(step_count, {"train/epoch": epoch, "train/epoch_seconds": dt,
                                   "train/steps_per_sec": steps / dt})

            record = {"epoch": epoch, "steps": steps, "seconds": dt, "busy_s": step_busy,
                      "val_s": None}
            self.history.append(record)
            is_val_epoch = (epoch + 1) % self.validation_interval == 0
            stop = False
            if self.validate_fn is not None and is_val_epoch:
                tv = time.monotonic()
                obj, scalars = self.validate_fn(self.state, epoch)
                record["val_s"] = time.monotonic() - tv
                scalars = dict(scalars)
                scalars["val/obj_metric"] = obj
                self._log(step_count, scalars)
                if self.ckpt is not None:
                    self._save("best", {"epoch": epoch, "best_obj": float(obj)}, obj=obj)
                if obj > self.best_obj:
                    self.best_obj = obj
                    self.epochs_since_best = 0
                else:
                    self.epochs_since_best += self.validation_interval
                stop = (self.early_stop_patience is not None
                        and self.epochs_since_best >= self.early_stop_patience)
            k = self.checkpoint_interval
            if k is None:
                k = self.validation_interval if self.validate_fn else 1
            if self.ckpt is not None and ((epoch + 1) % k == 0 or epoch == self.n_epochs - 1
                                          or stop):
                self._save("last", {"epoch": epoch, "best_obj": float(self.best_obj)})
            if stop:
                break
        if self.energy:
            kwh = self.energy.stop()
            self._log(step_count, {"train/energy_kwh_estimate": kwh})
        if wd is not None:
            wd.stop()
            if wd.stalls:
                self._log(step_count, {f"train/watchdog_{k}": float(v)
                                       for k, v in wd.stats().items()})
        return self.state
