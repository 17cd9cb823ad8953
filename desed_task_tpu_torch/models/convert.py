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

`convert_crnn_state_dict(state_dict)` loads a reference DESED_task PyTorch
CRNN checkpoint straight into the port's names (counterpart of
desed_task_tpu/models/torch_convert.py:47, with `convert_gru_state_dict`,
:364), with no detour through the flax names.
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


# reference DESED_task CRNN (desed_task/nnet/CRNN.py) state_dict -> the port's
_REF_PREFIX = (("cnn.cnn.", "cnn."), ("rnn.rnn.", "rnn."), ("shrink_emb.0.", "shrink_emb_dense."),
               ("shrink_emb.1.", "shrink_emb_ln."), ("frame_embs_encoder.", "frame_embs_encoder."),
               ("cat_tf.", "cat_tf."))
_REF_SKIP = re.compile(r"cnn\.cnn\.(dropout|pooling|relu)\d*\.|.*num_batches_tracked$")
_REF_CNN = re.compile(r"cnn\.(conv|batchnorm|glu)\d+\.")
_REF_HEAD = re.compile(r"(dense|dense_softmax)\.(?:(\d+)\.)?(weight|bias)$")


def _tensor(t) -> torch.Tensor:
    t = t.detach().cpu() if isinstance(t, torch.Tensor) else torch.from_numpy(np.asarray(t))
    return t.to(torch.float32).clone()


def convert_crnn_state_dict(state_dict: Mapping) -> dict:
    """A reference DESED_task CRNN state_dict (cnn.cnn.conv{i}.*,
    cnn.cnn.batchnorm{i}.*, cnn.cnn.glu{i}.linear.*, rnn.rnn.*_l{k}[_reverse],
    dense[.{i}].*, dense_softmax[.{i}].*, cat_tf.*, shrink_emb.{0,1}.*,
    frame_embs_encoder.*) -> the port's CRNN state_dict, float32.

    Layouts already agree (torch on both sides): conv [Co, Ci, 3, 3],
    Linear [out, in], GRU weights by torch.nn.GRU's names. Dropout, pooling
    and num_batches_tracked entries are dropped; a key no rule maps (the
    reference's layernorm or context-gating blocks, which the port's CNN
    does not have) raises KeyError."""
    out = {}
    for key, val in state_dict.items():
        if _REF_SKIP.match(key):
            continue
        name = None
        head = _REF_HEAD.fullmatch(key)
        if head:
            mod, idx, leaf = head.groups()
            name = f"{mod}{'' if idx is None else '_' + idx}.{leaf}"
        else:
            for src, dst in _REF_PREFIX:
                if key.startswith(src):
                    name = dst + key[len(src):]
                    break
        if name is None or (name.startswith("cnn.") and not _REF_CNN.match(name)):
            raise KeyError(f"unrecognized CRNN param {key!r}")
        out[name] = _tensor(val)
    return out


def convert_gru_state_dict(state_dict: Mapping, prefix: str = "") -> dict:
    """A torch.nn.GRU state_dict (keys under `prefix`) -> the state_dict of
    models.rnn.BidirectionalGRU (the same names)."""
    return {key[len(prefix):]: _tensor(val) for key, val in state_dict.items()
            if key.startswith(prefix)}
