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

`from_jax_tdcn_params(variables)` does the same for the 2021 separator
(models/tdcn.py) and `from_jax_ensemble_params(params, batch_stats)` for
the separation ensemble (models/ensemble.py).

`convert_crnn_state_dict(state_dict)` loads a reference DESED_task PyTorch
CRNN checkpoint straight into the port's names (counterpart of
desed_task_tpu/models/torch_convert.py:47, with `convert_gru_state_dict`,
:364), with no detour through the flax names.

The embedders (models/{beats,panns,ast}.py): `from_jax_embedder_params(
params, batch_stats)` maps the flax tree of BEATsModel, BEATsEncoder,
Cnn14_16k or ASTModel onto the port's module (`layer_{i}` / `block_{i}`
become `layers.{i}` / `blocks.{i}`). The released checkpoints' loaders
(`convert_{beats,panns,ast}_state_dict`, `load_*_checkpoint`,
`beats_config_from_checkpoint`; desed_task_tpu/models/torch_convert.py
:126-361) build the same nested numpy tree as the JAX package's, which
then goes through `from_jax_embedder_params`; `to_reference_{beats,panns,
ast}` write a port module's state_dict in the released layout.
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


_PRELU = re.compile(r"PReLU_(\d+)")


def _tdcn_leaf(path: tuple[str, ...], value: np.ndarray):
    *mods, leaf = path
    names = []
    for m in mods:
        prelu = _PRELU.fullmatch(m)
        if prelu:
            names.append(f"prelu{prelu.group(1)}")
        elif m != "LayerNorm_0":
            names.append("blocks." + m if m.startswith("block_") else m)
    name = None
    if leaf == "kernel" and mods == ["decoder"]:
        # ConvTranspose [win, enc, 1] -> conv_transpose1d [enc, 1, win], flipped
        name, value = "weight", value.transpose(1, 2, 0)[..., ::-1]
    elif leaf == "kernel" and value.ndim == 3 and value.shape[0] == 1 and mods[-1] != "dconv":
        name, value = "weight", value[0].T  # a 1x1 conv: Linear [out, in]
    elif leaf == "kernel" and value.ndim == 3:
        name, value = "weight", value.transpose(2, 1, 0)  # conv1d [Co, Ci / groups, k]
    elif leaf in ("negative_slope", "res_scale", "bias"):
        name = leaf
    elif leaf == "scale" and mods[-1:] == ["LayerNorm_0"]:
        name = "weight"
    if name is None:
        raise ValueError(f"no rule maps the JAX TDCN leaf {'/'.join(path)}")
    return ".".join(names + [name]), value


def from_jax_tdcn_params(variables: Mapping) -> dict:
    """Flax variables (or params) of the JAX TDCNPP -> the port's state_dict
    (models/tdcn.py): 1x1 convs to Linear [out, in], the depthwise and
    encoder kernels to [Co, Ci / groups, k], the decoder's ConvTranspose
    kernel to conv_transpose1d's [enc, 1, win] with the taps reversed,
    LayerNorm scale to weight. Every leaf is used."""
    params = variables.get("params", variables)
    state = {}
    for path, value in _leaves(params):
        key, value = _tdcn_leaf(path, value)
        if key in state:
            raise ValueError(f"two JAX leaves map to {key}")
        state[key] = torch.from_numpy(np.array(value, dtype=np.float32))
    return state


def from_jax_ensemble_params(params: Mapping, batch_stats: Mapping | None = None) -> dict:
    """Flax params (+ batch_stats) of the JAX EnsembleModel -> the port's
    state_dict of models/ensemble.EnsembleModel: the `multisrc_crnn`
    subtree through from_jax_params, and `q_logit`. Every leaf is used."""
    extra = set(params) - {"multisrc_crnn", "q_logit"}
    if extra or set(batch_stats or {}) - {"multisrc_crnn"}:
        raise ValueError(f"no rule maps the JAX ensemble subtrees {sorted(extra)}")
    sub = from_jax_params(params["multisrc_crnn"], (batch_stats or {}).get("multisrc_crnn"))
    state = {f"multisrc_crnn.{k}": v for k, v in sub.items()}
    state["q_logit"] = torch.tensor(float(np.asarray(params["q_logit"])), dtype=torch.float32)
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


# ---------------------------------------------------------------- embedders
_EMB_LAYER = re.compile(r"(layer|block)_(\d+)")
_EMB_KEEP = {"bias", "weight_v", "weight_g", "grep_a", "relative_attention_bias", "mask_token",
             "cls_token", "dist_token", "pos_embed"}


def _embedder_leaf(path: tuple[str, ...], value: np.ndarray, stats: bool):
    *mods, leaf = path
    names = []
    for m in mods:
        layer = _EMB_LAYER.fullmatch(m)
        names.append(f"{layer.group(1)}s.{layer.group(2)}" if layer else m)
    name = None
    if stats:
        name = {"mean": "running_mean", "var": "running_var"}.get(leaf)
    elif leaf == "kernel" and value.ndim == 4:
        name, value = "weight", value.transpose(3, 2, 0, 1)
    elif leaf == "kernel" and value.ndim == 2:
        name, value = "weight", value.T
    elif leaf == "scale":
        name = "weight"
    elif leaf in _EMB_KEEP:
        name = leaf
    if name is None:
        raise ValueError(f"no rule maps the JAX embedder leaf {'/'.join(path)}")
    return ".".join(names + [name]), value


def from_jax_embedder_params(params: Mapping, batch_stats: Mapping | None = None) -> dict:
    """Flax `params` (+ `batch_stats` for PANNs) of the JAX BEATsModel,
    BEATsEncoder, Cnn14_16k or ASTModel -> the port module's state_dict:
    Dense kernels transposed, conv kernels [kh, kw, in, out] to [out, in,
    kh, kw], LayerNorm / BatchNorm scale to weight, mean / var to
    running_*; weight_v, weight_g, grep_a, the relative bias, the tokens
    and the positional embedding as they are. Every leaf is used."""
    state = {}
    for collection, stats in ((params, False), (batch_stats or {}, True)):
        for path, value in _leaves(collection):
            key, value = _embedder_leaf(path, value, stats)
            if key in state:
                raise ValueError(f"two JAX leaves map to {key}")
            state[key] = torch.from_numpy(np.array(value, dtype=np.float32))
    return state


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if hasattr(t, "detach") else np.asarray(t)


def _set(tree: dict, path: tuple[str, ...], value: np.ndarray):
    node = tree
    for k in path[:-1]:
        node = node.setdefault(k, {})
    node[path[-1]] = value


_LN_LEAF = {"weight": "scale", "bias": "bias"}


def _dense_leaf(leaf: str, val: np.ndarray):
    return ("kernel", val.T) if leaf == "weight" else ("bias", val)


def convert_beats_state_dict(state_dict: Mapping) -> dict:
    """A released BEATs checkpoint's "model" state_dict -> the flax tree of
    BEATsEncoder (nested dicts of numpy arrays). The pretraining keys
    (predictor*, quantize*) are skipped, and of the relative bias, which
    every layer stores, layer 0's is kept (layers 1-11 share it); a key no
    rule maps raises KeyError."""
    params: dict = {}
    for key, t in state_dict.items():
        val = _np(t)
        parts = key.split(".")
        if parts[0] in ("predictor", "predictor_dropout", "quantize", "quantize_layer"):
            continue
        if parts[0] == "patch_embedding":
            leaf = {"weight": "kernel", "bias": "bias"}[parts[1]]
            _set(params, ("patch_embedding", leaf),
                 val.transpose(2, 3, 1, 0) if leaf == "kernel" else val)
        elif parts[0] == "layer_norm":
            _set(params, ("layer_norm", _LN_LEAF[parts[1]]), val)
        elif parts[0] == "post_extract_proj":
            leaf, v = _dense_leaf(parts[1], val)
            _set(params, ("post_extract_proj", leaf), v)
        elif parts[0] == "encoder" and parts[1] == "pos_conv":
            _set(params, ("encoder", "pos_conv", parts[3]), val)  # pos_conv.0.{weight_g,...}
        elif parts[0] == "encoder" and parts[1] == "layer_norm":
            _set(params, ("encoder", "layer_norm", _LN_LEAF[parts[2]]), val)
        elif parts[0] == "encoder" and parts[1] == "layers":
            i, sub = int(parts[2]), parts[3]
            base = ("encoder", f"layer_{i}")
            if sub == "self_attn":
                mod = parts[4]
                if mod == "relative_attention_bias":
                    if i == 0:
                        _set(params, base + ("self_attn", mod), val)
                elif mod == "grep_a":
                    _set(params, base + ("self_attn", "grep_a"), val)
                elif mod in ("grep_linear", "q_proj", "k_proj", "v_proj", "out_proj"):
                    leaf, v = _dense_leaf(parts[5], val)
                    _set(params, base + ("self_attn", mod, leaf), v)
                else:
                    raise KeyError(f"unrecognized BEATs layer param {key!r}")
            elif sub in ("self_attn_layer_norm", "final_layer_norm"):
                _set(params, base + (sub, _LN_LEAF[parts[4]]), val)
            elif sub in ("fc1", "fc2"):
                leaf, v = _dense_leaf(parts[4], val)
                _set(params, base + (sub, leaf), v)
            else:
                raise KeyError(f"unrecognized BEATs layer param {key!r}")
        else:
            raise KeyError(f"unrecognized BEATs param {key!r}")
    return params


def beats_config_from_checkpoint(cfg: Mapping):
    """A released checkpoint's "cfg" dict -> models.beats.BEATsConfig: the
    fields the encoder does not model are dropped, dropout is 0."""
    import dataclasses

    from .beats import BEATsConfig

    fields = {f.name for f in dataclasses.fields(BEATsConfig)}
    kwargs = {k: v for k, v in dict(cfg).items() if k in fields}
    kwargs["dropout"] = 0.0  # inference encoder
    return BEATsConfig(**kwargs)


def load_beats_checkpoint(ckpt_path) -> tuple:
    """A BEATs torch file {"cfg": dict, "model": state_dict} (the released
    layout, which training/beats_pretrain.py also writes) -> (BEATsConfig,
    flax tree of BEATsEncoder)."""
    ckpt = torch.load(ckpt_path, map_location="cpu", weights_only=False)
    return beats_config_from_checkpoint(ckpt.get("cfg", {})), convert_beats_state_dict(
        ckpt["model"])


def convert_panns_state_dict(state_dict: Mapping) -> dict:
    """A Cnn14_16k state_dict -> {"params", "batch_stats"} flax trees. The
    torchlibrosa STFT / mel buffers, fc1 and fc_audioset (unused by the
    embedding forward) and num_batches_tracked are skipped."""
    params: dict = {}
    stats: dict = {}
    for key, t in state_dict.items():
        val = _np(t)
        parts = key.split(".")
        if parts[0] in ("spectrogram_extractor", "logmel_extractor", "spec_augmenter", "fc1",
                        "fc_audioset"):
            continue
        if parts[0] == "bn0":
            mod, leaf = ("bn0",), parts[1]
        elif parts[0].startswith("conv_block"):
            mod, leaf = (parts[0], parts[1]), parts[2]
            if parts[1].startswith("conv"):
                _set(params, mod + ("kernel",), val.transpose(2, 3, 1, 0))
                continue
        else:
            raise KeyError(f"unrecognized PANNs param {key!r}")
        if leaf in _LN_LEAF:
            _set(params, mod + (_LN_LEAF[leaf],), val)
        elif leaf in ("running_mean", "running_var"):
            _set(stats, mod + (leaf[len("running_"):],), val)
    return {"params": params, "batch_stats": stats}


def load_panns_checkpoint(ckpt_path) -> dict:
    """A released Cnn14_16k file ({"model": state_dict}) -> flax variables."""
    ckpt = torch.load(ckpt_path, map_location="cpu", weights_only=False)
    return convert_panns_state_dict(ckpt["model"] if isinstance(ckpt, dict) and "model" in ckpt
                                    else ckpt)


def convert_ast_state_dict(state_dict: Mapping) -> dict:
    """An AST (timm DeiT wrapper) state_dict, the audio-adapted one (a
    1-channel patch conv, the positional embedding on the audio grid) ->
    the flax tree of ASTModel. The `v.` prefix is dropped; timm's own
    classification heads are skipped."""
    params: dict = {}
    for key, t in state_dict.items():
        val = _np(t)
        parts = key.split(".")
        if parts[0] == "v":
            parts = parts[1:]
        if parts[0] in ("cls_token", "dist_token", "pos_embed"):
            _set(params, (parts[0],), val)
        elif parts[0] == "patch_embed":
            _set(params, ("patch_proj", "kernel") if parts[-1] == "weight"
                 else ("patch_proj", "bias"),
                 val.transpose(2, 3, 1, 0) if parts[-1] == "weight" else val)
        elif parts[0] == "blocks":
            base, sub = (f"block_{int(parts[1])}",), parts[2]
            if sub in ("norm1", "norm2"):
                _set(params, base + (sub, _LN_LEAF[parts[3]]), val)
            elif sub in ("attn", "mlp"):  # attn.{qkv,proj}, mlp.{fc1,fc2}
                leaf, v = _dense_leaf(parts[4], val)
                _set(params, base + (parts[3], leaf), v)
            else:
                raise KeyError(f"unrecognized AST block param {key!r}")
        elif parts[0] == "norm":
            _set(params, ("norm", _LN_LEAF[parts[1]]), val)
        elif parts[0] == "mlp_head":
            if parts[1] == "0":
                _set(params, ("head_norm", _LN_LEAF[parts[2]]), val)
            else:
                leaf, v = _dense_leaf(parts[2], val)
                _set(params, ("head", leaf), v)
        elif parts[0] in ("head", "head_dist", "pre_logits"):
            continue
        else:
            raise KeyError(f"unrecognized AST param {key!r}")
    return params


def load_ast_checkpoint(ckpt_path) -> dict:
    """A released AST AudioSet file (a DataParallel state_dict, "module."
    prefixes) -> the flax tree of ASTModel."""
    sd = torch.load(ckpt_path, map_location="cpu", weights_only=False)
    if isinstance(sd, dict) and "model" in sd and not hasattr(sd["model"], "shape"):
        sd = sd["model"]
    return convert_ast_state_dict({(k[len("module."):] if k.startswith("module.") else k): v
                                   for k, v in sd.items()})


def to_reference_beats(state: Mapping, n_layers: int) -> dict:
    """A port BEATsEncoder state_dict -> the released layout's names: the
    positional conv under `encoder.pos_conv.0.`, the relative bias as an
    Embedding's weight in every layer (the reference shares layer 0's);
    the pretraining-only mask token is left out."""
    out = {}
    for key, val in state.items():
        if key == "mask_token":
            continue
        if key.startswith("encoder.pos_conv."):
            key = "encoder.pos_conv.0." + key[len("encoder.pos_conv."):]
        if key.endswith("self_attn.relative_attention_bias"):
            for i in range(n_layers):
                out[f"encoder.layers.{i}.self_attn.relative_attention_bias.weight"] = val
            continue
        out[key] = val
    return out


def to_reference_panns(state: Mapping) -> dict:
    """A port Cnn14_16k state_dict -> the released file's state_dict: the
    same names, with each BatchNorm's num_batches_tracked, the torchlibrosa
    STFT and mel buffers and the fc1 / fc_audioset heads (zeros)."""
    out = dict(state)
    for key in state:
        if key.endswith("running_var"):
            out[key[: -len("running_var")] + "num_batches_tracked"] = torch.tensor(0)
    out.update({
        "spectrogram_extractor.stft.conv_real.weight": torch.zeros(257, 1, 512),
        "spectrogram_extractor.stft.conv_imag.weight": torch.zeros(257, 1, 512),
        "logmel_extractor.melW": torch.zeros(257, 64),
        "fc1.weight": torch.zeros(2048, 2048), "fc1.bias": torch.zeros(2048),
        "fc_audioset.weight": torch.zeros(527, 2048), "fc_audioset.bias": torch.zeros(527)})
    return out


_AST_REF = (("patch_proj.", "v.patch_embed.proj."), ("norm.", "v.norm."),
            ("head_norm.", "mlp_head.0."), ("head.", "mlp_head.1."))
_AST_BLOCK = {"norm1": "norm1", "norm2": "norm2", "qkv": "attn.qkv", "proj": "attn.proj",
              "fc1": "mlp.fc1", "fc2": "mlp.fc2"}


def to_reference_ast(state: Mapping) -> dict:
    """A port ASTModel state_dict -> the released AudioSet file's names
    (DataParallel `module.` prefix, timm's `v.` wrapper, `mlp_head.{0,1}`)."""
    out = {}
    for key, val in state.items():
        parts = key.split(".")
        if parts[0] in ("cls_token", "dist_token", "pos_embed"):
            ref = "v." + key
        elif parts[0] == "blocks":
            ref = f"v.blocks.{parts[1]}.{_AST_BLOCK[parts[2]]}.{parts[3]}"
        else:
            ref = next(dst + key[len(src):] for src, dst in _AST_REF if key.startswith(src))
        out["module." + ref] = val
    return out
