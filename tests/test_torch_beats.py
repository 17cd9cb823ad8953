"""The port's BEATs (models/beats.py) against desed_task_tpu/models/beats.py on
the CPU, at a small config (2 layers, 64 wide, 4 heads, conv_pos 16 in 4
groups, 32 buckets) on 2-s clips (96 tokens), weights carried across by
`from_jax_embedder_params`.

Tolerances: outputs within 1e-4 of max(1, max |JAX|) (fp32, sums in
another order); the bucket table exactly. The LayerNorm epsilon: on fbank
of per-token variance ~1e-4 (where 1e-5 and 1e-6 differ by ~4 % after the
first LayerNorm) the port is held to JAX at the same bound, and the same
module with torch's default epsilon (1e-5) misses it.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from desed_task_tpu.models import beats as jb
from desed_task_tpu_torch.models import beats as tb
from desed_task_tpu_torch.models.convert import from_jax_embedder_params

SMALL = dict(embed_dim=32, encoder_layers=2, encoder_embed_dim=64, encoder_ffn_embed_dim=128,
             encoder_attention_heads=4, conv_pos=16, conv_pos_groups=4, num_buckets=32,
             max_distance=64)
TOL = 1e-4


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    err = np.abs(np.asarray(got) - want).max() / max(1.0, np.abs(want).max())
    return err <= tol, err


def _perturbed(params, seed):
    """Init values moved off their constants (LayerNorm 1 / 0, biases 0,
    weight_g and grep_a 1), so that every leaf's mapping shows."""
    r = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + (0.05 * r.standard_normal(a.shape)).astype(np.float32), params)


@pytest.fixture(scope="module")
def encoder_pair():
    cfg = jb.BEATsConfig(**SMALL)
    fb = jnp.zeros((1, 198, 128), jnp.float32)
    model = jb.BEATsEncoder(cfg)
    params = _perturbed(model.init(jax.random.key(0), fb, mask_indices=jnp.zeros((1, 96), bool))
                        ["params"], 1)
    port = tb.BEATsEncoder(tb.BEATsConfig(**SMALL), mask_token=True)
    port.load_state_dict(from_jax_embedder_params(params), strict=True)
    return model, params, port.eval()


def _fbank(seed, B=2, T=198, scale=1.0):
    return (np.random.default_rng(seed).standard_normal((B, T, 128)) * scale).astype(np.float32)


@pytest.mark.parametrize("q,k,nb,md", [(96, 96, 32, 64), (496, 496, 320, 800), (7, 11, 16, 20)])
def test_relative_position_buckets_equal(q, k, nb, md):
    got = tb.relative_position_buckets(q, k, nb, md)
    want = jb.relative_position_buckets(q, k, nb, md)
    assert got.dtype == want.dtype == np.int64
    np.testing.assert_array_equal(got, want)


def test_config_matches_jax():
    import dataclasses

    assert dataclasses.asdict(tb.BEATsConfig()) == dataclasses.asdict(jb.BEATsConfig())
    assert tb.BEATsConfig().deep_norm_alpha == jb.BEATsConfig().deep_norm_alpha


@pytest.mark.parametrize("case", ["plain", "mask_indices", "padding_mask"])
def test_encoder_matches_jax(encoder_pair, case):
    model, params, port = encoder_pair
    fb = _fbank(2)
    kw_j, kw_t = {}, {}
    if case == "mask_indices":
        mask = np.random.default_rng(3).random((2, 96)) < 0.6
        kw_j["mask_indices"], kw_t["mask_indices"] = jnp.asarray(mask), torch.from_numpy(mask)
    if case == "padding_mask":
        pad = np.zeros((2, 96), bool)
        pad[1, 80:] = True
        kw_j["padding_mask"], kw_t["padding_mask"] = jnp.asarray(pad), torch.from_numpy(pad)
    want = model.apply({"params": params}, jnp.asarray(fb), **kw_j)
    with torch.no_grad():
        got = port(torch.from_numpy(fb), **kw_t)
    assert got.shape == want.shape == (2, 96, 64)
    ok, err = _close(got.numpy(), want)
    assert ok, err


def test_model_on_audio_matches_jax():
    cfg = jb.BEATsConfig(**SMALL)
    model = jb.BEATsModel(cfg)
    audio = (np.random.default_rng(4).standard_normal((2, 32000)) * 0.1).astype(np.float32)
    params = _perturbed(model.init(jax.random.key(5), jnp.zeros((1, 32000)))["params"], 6)
    want = model.apply({"params": params}, jnp.asarray(audio))
    port = tb.BEATsModel(tb.BEATsConfig(**SMALL))
    port.load_state_dict(from_jax_embedder_params(params), strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(audio))
    assert got["frame"].shape == want["frame"].shape == (2, 64, 96)
    assert got["global"].shape == want["global"].shape == (2, 64)
    for k in ("frame", "global"):
        ok, err = _close(got[k].numpy(), want[k])
        assert ok, (k, err)


def test_layer_norm_epsilon_is_flax_default(encoder_pair):
    """fbank of std 1e-2: after the patch conv (weights of std ~1/16 over 256
    taps) each token's features have a variance ~1e-4."""
    model, params, port = encoder_pair
    fb = _fbank(7, scale=1e-2)
    want = model.apply({"params": params}, jnp.asarray(fb))
    with torch.no_grad():
        x = torch.nn.functional.conv2d(torch.from_numpy(fb)[:, None],
                                       port.patch_embedding.weight, stride=16)
        var = x.flatten(2).transpose(1, 2).var(-1, unbiased=False)
        assert 1e-5 < float(var.median()) < 1e-3
        got = port(torch.from_numpy(fb))
    ok, err = _close(got.numpy(), want)
    assert ok, err
    lns = [m for m in port.modules() if isinstance(m, torch.nn.LayerNorm)]
    assert len(lns) == 2 + 2 * SMALL["encoder_layers"] and all(m.eps == 1e-6 for m in lns)
    try:
        for m in lns:
            m.eps = 1e-5  # torch's default
        with torch.no_grad():
            ok, err = _close(port(torch.from_numpy(fb)).numpy(), want)
        assert not ok, f"eps 1e-5 is within the bound ({err})"
    finally:
        for m in lns:
            m.eps = 1e-6


def test_weight_norm_has_the_epsilon():
    conv = tb.WeightNormConvPos(8, 4, 2)
    with torch.no_grad():
        conv.weight_v.zero_()
        out = conv(torch.ones(1, 5, 8))
    assert torch.isfinite(out).all()  # v = 0: 0 / sqrt(1e-12), not 0 / 0


def test_init_is_seeded_and_fp32():
    a = tb.init_beats(tb.BEATsModel(tb.BEATsConfig(**SMALL)), torch.Generator().manual_seed(0))
    b = tb.init_beats(tb.BEATsModel(tb.BEATsConfig(**SMALL)), torch.Generator().manual_seed(0))
    for (n, p), q in zip(a.named_parameters(), b.parameters()):
        assert p.dtype == torch.float32 and torch.equal(p, q), n
    assert float(a.encoder.encoder.layers[0].self_attn.grep_a.detach().min()) == 1.0


def test_forward_pins_fp32_and_restores_the_flags():
    flags = (torch.backends.cudnn, torch.backends.cuda.matmul)
    prev = [f.allow_tf32 for f in flags]
    seen = []
    port = tb.BEATsModel(tb.BEATsConfig(**SMALL))
    handle = port.encoder.encoder.register_forward_pre_hook(
        lambda *_: seen.append([f.allow_tf32 for f in flags]))
    try:
        for f in flags:
            f.allow_tf32 = True
        with torch.no_grad():
            port(torch.zeros(1, 16000))
        assert seen == [[False, False]]
        assert all(f.allow_tf32 for f in flags)
    finally:
        handle.remove()
        for f, p in zip(flags, prev):
            f.allow_tf32 = p


def test_backward_after_an_inference_mode_forward():
    """The cached bucket table, first made under inference_mode (serving,
    extraction), serves a later gradient step (pretraining)."""
    cfg = dict(SMALL, max_distance=40)  # a table of its own in the cache
    model = tb.init_beats(tb.BEATsEncoder(tb.BEATsConfig(**cfg)), torch.Generator().manual_seed(1))
    fb = torch.from_numpy(_fbank(9, B=1))
    with torch.inference_mode():
        model(fb)
    model(fb).square().mean().backward()
    assert model.encoder.layers[0].self_attn.relative_attention_bias.grad is not None
