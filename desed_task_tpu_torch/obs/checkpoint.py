"""Checkpoints of the mean-teacher state (counterpart of
desed_task_tpu/obs/checkpoint.py; torch.save in place of orbax).

A checkpoint holds what an exact resume needs: the student's and the
teacher's state_dicts (parameters and BatchNorm buffers), the optimizer's
count and Adam moments, the step, the fitted scaler statistics and the
state of the step's torch.Generator. The JAX package folds the step into a
fixed key, so its resume needs no RNG state; the port's step draws from a
running generator, so a resumed run equals an uninterrupted one only if
the generator's state comes back too.

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


def state_payload(state, generator: torch.Generator | None = None) -> dict:
    """The checkpoint's contents: tensors on the host, plain containers."""
    scaler = state.scaler
    return {
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


def load_payload(payload: dict, state, generator: torch.Generator | None = None):
    """Load a checkpoint's contents into `state` (and `generator`) in place."""
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
        if payload["generator"] is None:
            raise ValueError("the checkpoint holds no generator state")
        generator.set_state(payload["generator"])
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
             generator: torch.Generator | None = None):
        """Save the whole state (and the generator's state) under `name`,
        replacing an earlier one."""
        path = self.directory / name
        tmp = path.with_name(f".{name}.tmp")
        torch.save(state_payload(state, generator), tmp)
        os.replace(tmp, path)
        if metadata is not None:
            (self.directory / f"{name}.meta.json").write_text(json.dumps(metadata, default=float))

    def save_if_best(self, state, score: float, metadata: dict | None = None,
                     generator: torch.Generator | None = None) -> bool:
        """Keep the single best checkpoint by score. Returns True if saved."""
        best = self._scores.get("best")
        if best is None or score > best:
            self._scores["best"] = float(score)
            self._meta_path.write_text(json.dumps({"scores": self._scores}))
            meta = dict(metadata or {})
            meta["score"] = float(score)
            self.save(state, meta, name="best", generator=generator)
            return True
        return False

    def restore(self, name: str, state, generator: torch.Generator | None = None):
        """Load checkpoint `name` into `state` (a MeanTeacherState of the same
        model) in place, and into `generator` when one is given; returns
        the state."""
        payload = torch.load(self.directory / name, map_location="cpu", weights_only=True)
        return load_payload(payload, state, generator)

    def metadata(self, name: str = "last") -> dict:
        p = self.directory / f"{name}.meta.json"
        return json.loads(p.read_text()) if p.exists() else {}

    def exists(self, name: str = "last") -> bool:
        return (self.directory / name).exists()
