"""The port's PANNs Cnn14_16k (models/panns.py) and AST (models/ast.py)
against the JAX modules on the CPU, weights carried across by
`from_jax_embedder_params`.

Tolerances: outputs within 1e-4 of max(1, max |JAX|) (fp32, sums in
another order; Cnn14 at its fixed widths on a 0.5-s clip, AST at depth 2,
width 64, 128 input frames); `resize_pos_embed` (24, 24) -> (12, 101)
within 1e-6 absolute of `jax.image.resize` (bilinear, antialiased where an
axis shrinks), and 1e-6 at an upsampling on both axes.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from desed_task_tpu.models import ast as jast
from desed_task_tpu.models import panns as jpanns
from desed_task_tpu_torch.models import ast as tast
from desed_task_tpu_torch.models import panns as tpanns
from desed_task_tpu_torch.models.convert import from_jax_embedder_params

TOL = 1e-4
SMALL_AST = dict(embed_dim=64, depth=2, num_heads=4, input_tdim=128, label_dim=7)


def _err(got, want):
    want = np.asarray(want)
    return np.abs(np.asarray(got) - want).max() / max(1.0, np.abs(want).max())


def _noisy(tree, seed, scale=0.05):
    r = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + scale * r.standard_normal(a.shape)).astype(np.float32), tree)


def test_panns_mel_config_matches_jax():
    import dataclasses

    want = dataclasses.asdict(jpanns.PANNS_MEL)
    got = dataclasses.asdict(tpanns.PANNS_MEL)
    assert {k: got[k] for k in want} == want


def test_cnn14_matches_jax():
    audio = (np.random.default_rng(0).standard_normal((2, 8000)) * 0.1).astype(np.float32)
    model = jpanns.Cnn14_16k()
    variables = model.init(jax.random.key(0), jnp.zeros((1, 8000), jnp.float32))
    params = _noisy(variables["params"], 1)
    r = np.random.default_rng(2)

    def stats_of(tree):  # running means off 0, variances off 1 (and positive)
        if "mean" in tree:
            return {"mean": (np.asarray(tree["mean"]) + r.standard_normal(tree["mean"].shape)
                             ).astype(np.float32),
                    "var": (np.asarray(tree["var"]) * np.exp(r.standard_normal(
                        tree["var"].shape))).astype(np.float32)}
        return {k: stats_of(v) for k, v in tree.items()}

    stats = stats_of(variables["batch_stats"])
    want = jax.jit(model.apply)({"params": params, "batch_stats": stats}, jnp.asarray(audio))
    port = tpanns.Cnn14_16k()
    port.load_state_dict(from_jax_embedder_params(params, stats), strict=True)
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(audio))
    assert got["frame"].shape == want["frame"].shape == (2, 2048, 6)
    assert got["global"].shape == want["global"].shape == (2, 2048)
    for k in ("frame", "global"):
        assert _err(got[k].numpy(), want[k]) <= TOL, (k, _err(got[k].numpy(), want[k]))


def test_ast_matches_jax():
    cfg = jast.ASTConfig(**SMALL_AST)
    assert (cfg.f_dim, cfg.t_dim) == (12, 12)
    model = jast.ASTModel(cfg)
    spec = np.random.default_rng(3).standard_normal((2, 128, 128)).astype(np.float32)
    params = _noisy(model.init(jax.random.key(4), jnp.zeros((1, 128, 128)))["params"], 5)
    want = jax.jit(model.apply)({"params": params}, jnp.asarray(spec))
    port = tast.ASTModel(tast.ASTConfig(**SMALL_AST))
    port.load_state_dict(from_jax_embedder_params(params), strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(spec))
    assert got["frame"].shape == want["frame"].shape == (2, 64, 2 + 144)
    assert got["global"].shape == want["global"].shape == (2, 7)
    for k in ("frame", "global"):
        assert _err(got[k].numpy(), want[k]) <= TOL, (k, _err(got[k].numpy(), want[k]))


def test_ast_shipped_config_shapes():
    cfg = tast.ASTConfig()
    assert (cfg.f_dim, cfg.t_dim, cfg.num_patches) == (12, 101, 1212)
    assert tast.ASTConfig().__dict__ == jast.ASTConfig().__dict__


@pytest.mark.parametrize("old,new", [((24, 24), (12, 101)), ((5, 7), (9, 13))])
def test_resize_pos_embed_matches_jax(old, new):
    pos = np.random.default_rng(6).standard_normal((1, old[0] * old[1], 16)).astype(np.float32)
    got = tast.resize_pos_embed(pos, old, new)
    want = jast.resize_pos_embed(pos, old, new)
    assert got.shape == want.shape == (1, new[0] * new[1], 16) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_inits_are_seeded():
    for build, init in ((tpanns.Cnn14_16k, tpanns.init_panns),
                        (lambda: tast.ASTModel(tast.ASTConfig(**SMALL_AST)), tast.init_ast)):
        a = init(build(), torch.Generator().manual_seed(0))
        b = init(build(), torch.Generator().manual_seed(0))
        assert all(torch.equal(p, q) for p, q in zip(a.state_dict().values(),
                                                     b.state_dict().values()))
