"""The port's loaders of the released embedder checkpoints (models/convert.py)
against desed_task_tpu/models/torch_convert.py, on facsimile files made from
a seed and written with torch.save:

  * BEATs {"cfg", "model"}: the released key names written out here by hand
    (weight-normed `encoder.pos_conv.0.weight_g` / `weight_v`, the relative
    bias in every layer, a fine-tuned file's `predictor.*`), and the port's
    own export (`to_reference_beats`, which the pretraining writes);
  * PANNs {"model": state_dict} with the torchlibrosa buffers, fc1 and
    num_batches_tracked (`to_reference_panns`, and the JAX tests' facsimile);
  * AST with the DataParallel `module.` and timm `v.` prefixes
    (`to_reference_ast`, and the JAX tests' facsimile).

The port's tree equals JAX's leaf by leaf (exactly: both are copies of the
same arrays), has the flax module's structure, and loads through
`from_jax_embedder_params` into the port's module strictly, giving back the
weights the file was written from. Unknown keys raise KeyError.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from desed_task_tpu.models import ast as jast
from desed_task_tpu.models import beats as jb
from desed_task_tpu.models import panns as jpanns
from desed_task_tpu.models import torch_convert as jtc
from desed_task_tpu_torch.models import ast as tast
from desed_task_tpu_torch.models import beats as tb
from desed_task_tpu_torch.models import convert as tc
from desed_task_tpu_torch.models import panns as tpanns

SMALL_CFG = dict(input_patch_size=16, embed_dim=32, encoder_layers=2, encoder_embed_dim=64,
                 encoder_ffn_embed_dim=128, encoder_attention_heads=4, activation_fn="gelu",
                 layer_norm_first=False, deep_norm=True, conv_bias=False, conv_pos=16,
                 conv_pos_groups=4, relative_position_embedding=True, num_buckets=32,
                 max_distance=64, gru_rel_pos=True,
                 # fields of the released cfg that the encoder does not model
                 dropout=0.1, attention_dropout=0.1, finetuned_model=True,
                 predictor_dropout=0.1, predictor_class=527)
SMALL_AST = dict(embed_dim=32, depth=2, num_heads=2, input_tdim=64, input_fdim=32, label_dim=7)


def _released_beats(g: torch.Generator) -> dict:
    """A BEATs_iter3+ state_dict under the released names, small widths."""
    t = lambda *s: torch.randn(*s, generator=g) * 0.05
    D, E, F, H, L = 64, 32, 128, 4, 2
    sd = {"patch_embedding.weight": t(E, 1, 16, 16), "layer_norm.weight": 1 + t(E),
          "layer_norm.bias": t(E), "post_extract_proj.weight": t(D, E),
          "post_extract_proj.bias": t(D), "encoder.pos_conv.0.bias": t(D),
          "encoder.pos_conv.0.weight_g": 1 + t(1, 1, 16),
          "encoder.pos_conv.0.weight_v": t(D, D // 4, 16), "encoder.layer_norm.weight": 1 + t(D),
          "encoder.layer_norm.bias": t(D), "predictor.weight": t(527, D),
          "predictor.bias": t(527)}
    for i in range(L):
        p = f"encoder.layers.{i}."
        for m in ("q_proj", "k_proj", "v_proj", "out_proj"):
            sd[p + f"self_attn.{m}.weight"], sd[p + f"self_attn.{m}.bias"] = t(D, D), t(D)
        sd[p + "self_attn.relative_attention_bias.weight"] = t(32, H)
        sd[p + "self_attn.grep_a"] = 1 + t(1, H, 1, 1)
        sd[p + "self_attn.grep_linear.weight"], sd[p + "self_attn.grep_linear.bias"] = (
            t(8, D // H), t(8))
        for ln in ("self_attn_layer_norm", "final_layer_norm"):
            sd[p + f"{ln}.weight"], sd[p + f"{ln}.bias"] = 1 + t(D), t(D)
        sd[p + "fc1.weight"], sd[p + "fc1.bias"] = t(F, D), t(F)
        sd[p + "fc2.weight"], sd[p + "fc2.bias"] = t(D, F), t(D)
    return sd


def _assert_same_tree(got, want, path=""):
    assert set(got) == set(want), (path, sorted(set(got) ^ set(want)))
    for k in want:
        if isinstance(want[k], dict):
            _assert_same_tree(got[k], want[k], f"{path}/{k}")
        else:
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, path + k
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{path}/{k}")


def _structure(tree):
    return jax.tree_util.tree_structure(jax.tree_util.tree_map(jnp.asarray, tree))


def _init_structure(model, *args):
    """The flax module's variables' tree structure (traced, not computed)."""
    return jax.tree_util.tree_structure(jax.eval_shape(model.init, jax.random.key(0), *args))


@pytest.mark.parametrize("source", ["released", "port_export"])
def test_beats_loader_matches_jax(tmp_path, source):
    g = torch.Generator().manual_seed(0)
    if source == "released":
        sd = _released_beats(g)
        original = None
    else:
        enc = tb.init_beats(tb.BEATsEncoder(tb.BEATsConfig(**{
            k: v for k, v in SMALL_CFG.items() if k in tb.BEATsConfig.__dataclass_fields__})),
            g)
        original = enc.state_dict()
        sd = tc.to_reference_beats(original, SMALL_CFG["encoder_layers"])
        assert "encoder.layers.1.self_attn.relative_attention_bias.weight" in sd
    path = tmp_path / "BEATs_iter3_plus_AS2M_facsimile.pt"
    torch.save({"cfg": dict(SMALL_CFG), "model": sd}, path)

    cfg_j, tree_j = jtc.load_beats_checkpoint(str(path))
    cfg_t, tree_t = tc.load_beats_checkpoint(path)
    assert dataclasses.asdict(cfg_t) == dataclasses.asdict(cfg_j)
    assert cfg_t.dropout == 0.0 and cfg_t.encoder_embed_dim == 64
    _assert_same_tree(tree_t, tree_j)
    fb = jnp.zeros((1, 198, 128), jnp.float32)
    assert _structure({"params": tree_t}) == _init_structure(jb.BEATsEncoder(cfg_j), fb)

    port = tb.BEATsEncoder(cfg_t)
    port.load_state_dict(tc.from_jax_embedder_params(tree_t), strict=True)
    got = port.state_dict()
    want = original or {k.replace("pos_conv.0.", "pos_conv.").replace(
        "relative_attention_bias.weight", "relative_attention_bias"): v for k, v in sd.items()
        if not k.startswith("predictor") and not (
            "relative_attention_bias" in k and ".layers.0." not in k)}
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k


def test_panns_loader_matches_jax(tmp_path):
    from test_converters import _panns_state_dict

    port = tpanns.init_panns(tpanns.Cnn14_16k(), torch.Generator().manual_seed(1))
    ref = _init_structure(jpanns.Cnn14_16k(), jnp.zeros((1, 8000), jnp.float32))
    for i, sd in enumerate((tc.to_reference_panns(port.state_dict()), _panns_state_dict())):
        assert "spectrogram_extractor.stft.conv_real.weight" in sd and "fc1.weight" in sd
        path = tmp_path / f"Cnn14_16k_facsimile_{i}.pth"
        torch.save({"model": sd}, path)
        want = jtc.load_panns_checkpoint(str(path))
        got = tc.load_panns_checkpoint(path)
        _assert_same_tree(got, want)
        assert _structure(got) == ref
        m = tpanns.Cnn14_16k()
        m.load_state_dict(tc.from_jax_embedder_params(got["params"], got["batch_stats"]),
                          strict=True)
        if i == 0:
            assert all(torch.equal(a, b) for a, b in zip(m.state_dict().values(),
                                                         port.state_dict().values()))


def test_ast_loader_matches_jax(tmp_path):
    from test_converters import _ast_state_dict

    cfg = tast.ASTConfig(**SMALL_AST)
    port = tast.init_ast(tast.ASTModel(cfg), torch.Generator().manual_seed(2))
    jax_sd = {f"module.{k}": v for k, v in _ast_state_dict(jast.ASTConfig(**SMALL_AST)).items()}
    ref = _init_structure(jast.ASTModel(jast.ASTConfig(**SMALL_AST)),
                          jnp.zeros((1, 64, 32), jnp.float32))
    for i, sd in enumerate((tc.to_reference_ast(port.state_dict()), jax_sd)):
        assert all(k.startswith("module.") for k in sd)
        path = tmp_path / f"audioset_10_10_0.4593_facsimile_{i}.pth"
        torch.save(sd, path)
        want = jtc.load_ast_checkpoint(str(path))
        got = tc.load_ast_checkpoint(path)
        _assert_same_tree(got, want)
        assert _structure({"params": got}) == ref
        m = tast.ASTModel(cfg)
        m.load_state_dict(tc.from_jax_embedder_params(got), strict=True)
        if i == 0:
            assert all(torch.equal(a, b) for a, b in zip(m.state_dict().values(),
                                                         port.state_dict().values()))


@pytest.mark.parametrize("kind,key", [
    ("beats", "encoder.layers.0.mystery_param"), ("beats", "mystery.weight"),
    ("panns", "mystery.weight"), ("panns", "fc2.weight"), ("ast", "v.blocks.0.mystery.weight"),
    ("ast", "mystery")])
def test_unknown_keys_raise(kind, key):
    sd = {key: torch.zeros(3)}
    convert = {"beats": tc.convert_beats_state_dict, "panns": tc.convert_panns_state_dict,
               "ast": tc.convert_ast_state_dict}[kind]
    with pytest.raises(KeyError):
        convert(sd)


def test_from_jax_embedder_params_refuses_an_unmapped_leaf():
    with pytest.raises(ValueError, match="no rule maps"):
        tc.from_jax_embedder_params({"encoder": {"mystery": np.zeros(3, np.float32)}})
