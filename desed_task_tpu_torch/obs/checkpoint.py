"""Checkpoints of the mean-teacher state (counterpart of
desed_task_tpu/obs/checkpoint.py; torch.save in place of orbax).

A checkpoint holds what an exact resume needs: the student's and the
teacher's state_dicts (parameters and BatchNorm buffers), the optimizer's
count and Adam moments, the step, the fitted scaler statistics and the
state of the step's torch.Generator. The JAX package folds the step into a
fixed key, so its resume needs no RNG state; the port's step draws from a
running generator, so a resumed run equals an uninterrupted one only if
the generator's state comes back too. A run on a mesh has a generator on
every rank: its checkpoint also holds every rank's state
(`rank_generators`, in global rank order over all the mesh's axes), and
each rank restores its own by its global rank.

Keeps `last` and the top-1 `best` by objective (mode max), as the
reference's ModelCheckpoint (train_pretrained.py:560-581); `manager.json`
holds the best score, `<name>.meta.json` each checkpoint's metadata. A
checkpoint is written to a temporary file and renamed, so a cut run leaves
the previous one whole; it is read with `weights_only=True`.
"""

from __future__ import annotations

import json
import os
from pathlib import Path

import torch


def _host(tensors):
    return [t.detach().cpu() for t in tensors]


def state_payload(state, generator: torch.Generator | None = None,
                  rank_generators: list | None = None) -> dict:
    """The checkpoint's contents: tensors on the host, plain containers.
    rank_generators: every rank's generator state, in global rank order."""
    scaler = state.scaler
    payload = {
        "step": int(state.step),
        "student": {k: v.detach().cpu() for k, v in state.student.state_dict().items()},
        "teacher": {k: v.detach().cpu() for k, v in state.teacher.state_dict().items()},
        "opt_state": {"count": int(state.opt_state["count"]),
                      "mu": _host(state.opt_state["mu"]),
                      "nu": _host(state.opt_state["nu"])},
        "scaler": None if scaler is None else {
            "mean": scaler.mean, "mean_squared": scaler.mean_squared},
        "generator": None if generator is None else generator.get_state(),
    }
    if rank_generators is not None:
        payload["rank_generators"] = rank_generators
    return payload


def load_payload(payload: dict, state, generator: torch.Generator | None = None,
                 rank: int | None = None):
    """Load a checkpoint's contents into `state` (and `generator`) in place;
    with `rank`, the generator takes that rank's saved state."""
    from ..ops.scaler import ScalerState

    state.step = int(payload["step"])
    state.student.load_state_dict(payload["student"])
    state.teacher.load_state_dict(payload["teacher"])
    opt = payload["opt_state"]
    if state.opt_state:
        with torch.no_grad():
            for dst, src in zip(state.opt_state["mu"] + state.opt_state["nu"],
                                opt["mu"] + opt["nu"]):
                dst.copy_(src)
        state.opt_state["count"] = int(opt["count"])
    if payload["scaler"] is not None:
        state.scaler = ScalerState(**payload["scaler"])
    if generator is not None:
        if rank is None:
            saved = payload["generator"]
        else:
            ranks = payload.get("rank_generators") or []
            saved = ranks[rank] if rank < len(ranks) else None
        if saved is None:
            raise ValueError(f"the checkpoint holds no generator state"
                             f"{'' if rank is None else f' for rank {rank}'}")
        generator.set_state(saved)
    return state


class CheckpointManager:
    def __init__(self, directory):
        self.directory = Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self._scores: dict[str, float] = {}
        self._meta_path = self.directory / "manager.json"
        if self._meta_path.exists():
            self._scores = json.loads(self._meta_path.read_text()).get("scores", {})

    def save(self, state, metadata: dict | None = None, name: str = "last",
             generator: torch.Generator | None = None, rank_generators: list | None = None):
        """Save the whole state (and the generator's state, and each rank's)
        under `name`, replacing an earlier one."""
        path = self.directory / name
        tmp = path.with_name(f".{name}.tmp")
        torch.save(state_payload(state, generator, rank_generators), tmp)
        os.replace(tmp, path)
        if metadata is not None:
            (self.directory / f"{name}.meta.json").write_text(json.dumps(metadata, default=float))

    def save_if_best(self, state, score: float, metadata: dict | None = None,
                     generator: torch.Generator | None = None,
                     rank_generators: list | None = None) -> bool:
        """Keep the single best checkpoint by score. Returns True if saved."""
        best = self._scores.get("best")
        if best is None or score > best:
            self._scores["best"] = float(score)
            self._meta_path.write_text(json.dumps({"scores": self._scores}))
            meta = dict(metadata or {})
            meta["score"] = float(score)
            self.save(state, meta, name="best", generator=generator,
                      rank_generators=rank_generators)
            return True
        return False

    def restore(self, name: str, state, generator: torch.Generator | None = None,
                rank: int | None = None):
        """Load checkpoint `name` into `state` (a MeanTeacherState of the same
        model) in place, and into `generator` when one is given (rank
        `rank`'s saved state, where given); returns the state."""
        return load_payload(self.load(name), state, generator, rank)

    def load(self, name: str) -> dict:
        """Checkpoint `name`'s contents (state_payload's dict, on the host)."""
        return torch.load(self.directory / name, map_location="cpu", weights_only=True)

    def metadata(self, name: str = "last") -> dict:
        p = self.directory / f"{name}.meta.json"
        return json.loads(p.read_text()) if p.exists() else {}

    def exists(self, name: str = "last") -> bool:
        return (self.directory / name).exists()
