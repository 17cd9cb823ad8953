"""The port's TDCN++ separator (models/tdcn.py) against the JAX model
(desed_task_tpu/models/tdcn.py) on the CPU, weights through
`from_jax_tdcn_params`, at narrow widths (enc 16, h 32, bn 8, 2 repeats of
2 blocks) and at the default basis (win 40, stride 20) and others.

Tolerances: the separated sources within 1e-5 absolute (fp32, sums in
another order; the sources are ~0.1); mixture consistency within 1e-6;
gradients of the MixIT loss within 1e-4 of each tensor's largest entry
(above a floor of 1e-3 of the largest gradient overall, for the decoder
bias, whose exact gradient is 0).
Also: every JAX leaf used and the state_dict loading strictly, a leaf no
rule maps raising, the same parameter shapes, and the init distributions
(flax's lecun_normal scales per kernel, zero biases, unit LayerNorm
scales, PReLU slopes 0.01, residual scales 0.9^layer), and TF32 off for
cuDNN and cuBLAS inside the forward, the process's settings restored.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from desed_task_tpu.models.tdcn import TDCNPP as JaxTDCN
from desed_task_tpu.training import mixit as jmix
from desed_task_tpu_torch.models.convert import _leaves, from_jax_tdcn_params
from desed_task_tpu_torch.models.tdcn import TDCNPP, fp32_math, init_tdcn, same_padding
from desed_task_tpu_torch.training import mixit as tmix

NARROW = dict(enc_dim=16, bn_dim=8, h_dim=32, n_blocks=2, n_repeats=2)


def _perturbed(variables, seed):
    """Random biases, scales and slopes so that every leaf matters."""
    r = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + (0.05 * r.standard_normal(np.shape(a))).astype(np.float32),
        jax.device_get(variables))


def _pair(n_src, win, n, seed=0):
    kw = dict(NARROW, n_src=n_src, win=win)
    jm = JaxTDCN(**kw)
    x = (np.random.default_rng(seed).standard_normal((2, n)) * 0.1).astype(np.float32)
    v = _perturbed(jm.init(jax.random.key(seed), jnp.asarray(x)), seed + 1)
    tm = TDCNPP(**kw)
    tm.load_state_dict(from_jax_tdcn_params(v), strict=True)
    return jm, v, tm, x


@pytest.mark.parametrize("n_src,win,n", [(2, 40, 16000), (4, 40, 16000), (4, 40, 16013),
                                         (2, 16, 1605), (4, 15, 1001)])
def test_forward_matches_jax(n_src, win, n):
    jm, v, tm, x = _pair(n_src, win, n)
    want = np.asarray(jm.apply(v, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, n_src, n)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # mixture consistency: the sources sum to the input
    np.testing.assert_allclose(got.sum(1), x, rtol=0, atol=1e-6)


def test_mixture_consistency_off():
    jm, v, _, x = _pair(2, 16, 800)
    kw = dict(NARROW, n_src=2, win=16, mixture_consistency=False)
    tm = TDCNPP(**kw)
    tm.load_state_dict(from_jax_tdcn_params(v))
    want = np.asarray(JaxTDCN(**kw).apply(v, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert np.abs(got.sum(1) - x).max() > 1e-3


@pytest.mark.parametrize("length,k,s,d", [(1600, 40, 20, 1), (1605, 40, 20, 1), (100, 3, 1, 4),
                                          (1001, 15, 7, 1), (30, 40, 20, 1)])
def test_same_padding_is_lax_same(length, k, s, d):
    lo, hi = same_padding(length, k, s, d)
    pads = jax.lax.padtype_to_pads((length,), ((k - 1) * d + 1,), (s,), "SAME")
    assert (lo, hi) == tuple(pads[0])


def test_mixit_gradients_match_jax():
    jm, v, tm, _ = _pair(4, 40, 1600, seed=3)
    r = np.random.default_rng(4)
    audio = (r.standard_normal((4, 1600)) * 0.1).astype(np.float32)
    moms, pairs = jmix.mixture_of_mixtures(jnp.asarray(audio))
    g_jax = jax.grad(lambda p: jmix.mixit_loss(jm.apply(p, moms), pairs)[0])(v)
    want = from_jax_tdcn_params(jax.device_get(g_jax))
    t_moms, t_pairs = tmix.mixture_of_mixtures(torch.from_numpy(audio))
    tmix.mixit_loss(tm(t_moms), t_pairs)[0].backward()
    # the last block's residual output feeds nothing: no gradient (JAX: zeros)
    got = {n: torch.zeros_like(p) if p.grad is None else p.grad
           for n, p in tm.named_parameters()}
    assert got.keys() == want.keys()
    # the decoder bias's exact gradient is 0 (mixture consistency removes a
    # common offset of the sources): both sides give noise, held to the floor
    floor = 1e-3 * max(float(np.abs(w.numpy()).max()) for w in want.values())
    for name, g in got.items():
        w = want[name].numpy()
        scale = max(float(np.abs(w).max()), floor)
        err = float(np.abs(g.numpy() - w).max())
        assert err <= 1e-4 * scale, (name, err, scale)


def test_converter_uses_every_leaf():
    jm = JaxTDCN(**NARROW, n_src=4)
    v = jax.device_get(jm.init(jax.random.key(0), jnp.zeros((1, 800))))
    sd = from_jax_tdcn_params(v)
    assert len(sd) == len(list(_leaves(v["params"])))
    tm = TDCNPP(**NARROW, n_src=4)
    assert {k: tuple(t.shape) for k, t in sd.items()} == {
        k: tuple(t.shape) for k, t in tm.state_dict().items()}
    tm.load_state_dict(sd, strict=True)
    bad = {"params": dict(v["params"], extra={"gamma": np.zeros(3, np.float32)})}
    with pytest.raises(ValueError, match="no rule maps"):
        from_jax_tdcn_params(bad)


def test_init_distributions():
    kw = dict(enc_dim=64, bn_dim=32, h_dim=128, n_blocks=3, n_repeats=2, n_src=4, win=40)
    tm = init_tdcn(TDCNPP(**kw), torch.Generator().manual_seed(0))
    jv = from_jax_tdcn_params(jax.device_get(
        JaxTDCN(**kw).init(jax.random.key(0), jnp.zeros((1, 800)))))
    sd = tm.state_dict()
    for name, w in jv.items():
        got = sd[name].numpy()
        w = w.numpy()
        if name.endswith("weight") and w.ndim >= 2:
            # lecun_normal: std 1/sqrt(fan_in), truncated at 2 std
            assert abs(got.std() / w.std() - 1) < 0.25, name
            assert np.abs(got).max() <= 2 / 0.8796 * w.std() * 1.3, name
        else:  # biases, LN scales, PReLU slopes, residual scales: constants
            np.testing.assert_array_equal(got, w, err_msg=name)
    assert float(sd["blocks.block_r1_b2.res_scale"][0]) == pytest.approx(0.9 ** 5)
    assert float(sd["prelu0.negative_slope"]) == pytest.approx(0.01)


def test_forward_keeps_tf32_off_and_restores_the_setting():
    model = TDCNPP(n_src=2, enc_dim=8, win=16, bn_dim=8, h_dim=8, n_blocks=1, n_repeats=1)
    flags = (torch.backends.cudnn, torch.backends.cuda.matmul)
    seen = []
    for m in (model.encoder, model.bottleneck, model.decoder):
        m.register_forward_hook(lambda *a: seen.append([f.allow_tf32 for f in flags]))
    prev = [f.allow_tf32 for f in flags]
    try:
        for f in flags:
            f.allow_tf32 = True
        with torch.no_grad():
            model(torch.zeros(1, 1600))
        with fp32_math():
            inside = [f.allow_tf32 for f in flags]
        after = [f.allow_tf32 for f in flags]
    finally:
        for f, p in zip(flags, prev):
            f.allow_tf32 = p
    assert seen == [[False, False]] * 3 and inside == [False, False]
    assert after == [True, True]
