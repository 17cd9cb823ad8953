"""Weights of the JAX model (flax variables) -> the port's state_dict.

`from_jax_params(params, batch_stats)` takes the JAX CRNN's `params` and
`batch_stats` collections as nested dicts of numpy arrays and returns a
state_dict for `models.crnn.CRNN`:

  * flax Dense kernels are [in, out]; torch Linear weights are [out, in];
  * conv kernels [3, 3, Ci, Co] become torch's [Co, Ci, 3, 3];
  * BatchNorm / LayerNorm / GroupNorm `scale` is torch's `weight`, the
    batch_stats `mean` / `var` are `running_mean` / `running_var`;
  * GRU weights are already in torch layout: l{k}_fwd/weight_ih becomes
    weight_ih_l{k}, l{k}_bwd/... becomes ..._l{k}_reverse;
  * glu{i}/Dense_0 and cg{i}/Dense_0 become glu{i}.linear / cg{i}.linear.

Every leaf is used: a leaf no rule maps raises, and loading the result with
`load_state_dict(strict=True)` raises for a missing or extra key.
"""

from __future__ import annotations

import re
from typing import Mapping

import numpy as np
import torch

_GRU_DIR = re.compile(r"l(\d+)_(fwd|bwd)")


def _leaves(tree: Mapping, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), np.asarray(v)


def _convert_leaf(path: tuple[str, ...], value: np.ndarray, stats: bool):
    *mods, leaf = path
    names = []
    gru = None
    for m in mods:
        match = _GRU_DIR.fullmatch(m)
        if match:
            gru = (match.group(1), match.group(2) == "bwd")
        elif m == "Dense_0":
            names.append("linear")
        else:
            names.append(m)
    if stats:
        name = {"mean": "running_mean", "var": "running_var"}.get(leaf)
    elif gru is not None:
        layer, reverse = gru
        name = None
        if leaf in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"):
            name = f"{leaf}_l{layer}" + ("_reverse" if reverse else "")
    elif leaf == "kernel" and value.ndim == 4:
        name, value = "weight", value.transpose(3, 2, 0, 1)
    elif leaf == "kernel" and value.ndim == 2:
        name, value = "weight", value.T
    else:
        name = {"scale": "weight", "bias": "bias"}.get(leaf)
    if name is None:
        raise ValueError(f"no rule maps the JAX leaf {'/'.join(path)}")
    return ".".join(names + [name]), value


def from_jax_params(params: Mapping, batch_stats: Mapping | None = None) -> dict:
    """Flax `params` (+ `batch_stats`) of the JAX CRNN -> the port's state_dict."""
    state = {}
    for collection, stats in ((params, False), (batch_stats or {}, True)):
        for path, value in _leaves(collection):
            key, value = _convert_leaf(path, value, stats)
            if key in state:
                raise ValueError(f"two JAX leaves map to {key}")
            state[key] = torch.from_numpy(np.array(value, dtype=np.float32))
    return state
