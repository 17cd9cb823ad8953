"""Gradients of the port's fused conv block (plain backward versions on the
CPU) against the JAX block's custom VJPs with the Pallas kernels in
interpret mode, on the same numpy inputs and, with dropout, the same bits.

Tolerances: fp32 sums in another order. Gradients are compared relative to
each tensor's largest entry (1e-4). The conv bias's exact gradient is 0
(train-mode BatchNorm cancels it, tests/test_pallas_cnn.py:112-114): both
sides give fp32 cancellation noise, held to an absolute 1e-5 of the other
gradients' scale.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from desed_task_tpu.ops import pallas_cnn
from desed_task_tpu_torch.ops import fused_cnn

# (B, T, F, Ci, Co, pool): Ci=1 as the first 2024 block; odd T with pt=2
# (the last row is outside the pool but inside the statistics); F-pool in
# the kernel. The JAX epilogue needs F*Co to be a multiple of 128.
GEOMS = [
    (2, 13, 16, 1, 8, (2, 2)),
    (2, 10, 8, 8, 16, (1, 2)),
    (3, 9, 8, 16, 32, (2, 2)),
]
NAMES = ("x", "w", "bias", "gamma", "beta", "wg", "bg")


def _inputs(B, T, F, Ci, Co, seed):
    r = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)
    return dict(
        x=f32(r.standard_normal((B, T, F, Ci))),
        w=f32(r.standard_normal((3, 3, Ci, Co)) * 0.3),
        bias=f32(r.standard_normal(Co) * 0.1),
        gamma=f32(1.0 + 0.1 * r.standard_normal(Co)),
        beta=f32(0.1 * r.standard_normal(Co)),
        ra_mean=f32(0.05 * r.standard_normal(Co)),
        ra_var=f32(1.0 + 0.1 * r.random(Co)),
        wg=f32(r.standard_normal((Co, Co)) * 0.3),
        bg=f32(r.standard_normal(Co) * 0.1),
    )


def _jax_block(a, gz, pool, rate, key):
    def f(x, w, bias, gamma, beta, wg, bg):
        return pallas_cnn.fused_glu_block(
            x, w, bias, gamma, beta, jnp.asarray(a["ra_mean"]), jnp.asarray(a["ra_var"]),
            wg, bg, pool=pool, train=True, dropout_rate=rate, dropout_key=key,
            interpret=True, fpool_in_kernel=True)

    (z, m, v), vjp = jax.vjp(f, *(jnp.asarray(a[k]) for k in NAMES))
    zero = jnp.zeros_like(m)
    grads = vjp((jnp.asarray(gz), zero, zero))
    return np.asarray(z), np.asarray(m), np.asarray(v), [np.asarray(g) for g in grads]


def _port_block(a, gz, pool, rate, bits):
    leaves = {k: torch.from_numpy(a[k]).requires_grad_() for k in NAMES}
    z, m, v = fused_cnn.fused_glu_block(
        leaves["x"], leaves["w"], leaves["bias"], leaves["gamma"], leaves["beta"],
        torch.from_numpy(a["ra_mean"]), torch.from_numpy(a["ra_var"]), leaves["wg"],
        leaves["bg"], pool=pool, train=True, dropout_rate=rate, bits=bits)
    grads = torch.autograd.grad((z * torch.from_numpy(gz)).sum(), [leaves[k] for k in NAMES])
    return z.detach().numpy(), m.numpy(), v.numpy(), [g.numpy() for g in grads]


@pytest.mark.parametrize("geom", GEOMS)
@pytest.mark.parametrize("rate", [0.0, 0.5])
def test_fused_glu_block_gradients_match_jax(geom, rate):
    B, T, F, Ci, Co, pool = geom
    a = _inputs(B, T, F, Ci, Co, seed=3)
    gz = np.random.default_rng(4).standard_normal(
        (B, T // pool[0], F // pool[1], Co)).astype(np.float32)
    key = jax.random.key(9) if rate else None
    zj, mj, vj, gj = _jax_block(a, gz, pool, rate, key)
    bits = None
    if rate:  # JAX draws [B, Tp, F*Co] (T rounded up to 8); the port takes [B, T, F*Co]
        dims = pallas_cnn.BlockDims(B, T, F, Ci, Co, *pool)
        bits = torch.from_numpy(np.ascontiguousarray(
            np.asarray(jax.random.bits(key, (B, dims.Tp, dims.Lout), jnp.uint8))[:, :T]))
    z, m, v, g = _port_block(a, gz, pool, rate, bits)
    np.testing.assert_allclose(z, zj, rtol=1e-5, atol=1e-5)
    # new running statistics (biased batch variance, momentum 0.01)
    np.testing.assert_allclose(m, mj, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(v, vj, rtol=1e-5, atol=1e-6)
    scale = max(float(np.abs(x).max()) for x in gj)
    for name, got, want in zip(NAMES, g, gj):
        assert got.shape == want.shape, name
        if name == "bias":
            assert np.abs(got).max() <= 1e-5 * scale and np.abs(want).max() <= 1e-5 * scale
            continue
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max(),
                                   err_msg=name)


def test_running_stats_update_is_detached():
    a = _inputs(2, 5, 4, 3, 4, seed=5)
    x = torch.from_numpy(a["x"]).requires_grad_()
    _, m, v = fused_cnn.fused_glu_block(
        x, *(torch.from_numpy(a[k]) for k in ("w", "bias", "gamma", "beta", "ra_mean",
                                              "ra_var", "wg", "bg")),
        pool=(1, 2), train=True)
    assert not m.requires_grad and not v.requires_grad


def test_conv_bn_stats_gradcheck():
    g = torch.Generator().manual_seed(0)
    args = [torch.randn(2, 3, 4, 2, generator=g, dtype=torch.float64, requires_grad=True),
            torch.randn(3, 3, 2, 3, generator=g, dtype=torch.float64, requires_grad=True),
            torch.randn(3, generator=g, dtype=torch.float64, requires_grad=True)]
    assert torch.autograd.gradcheck(fused_cnn.ConvBnStats.apply, args)


@pytest.mark.parametrize("pool,with_bits", [((2, 2), True), ((3, 1), False)])
def test_glu_drop_pool_gradcheck(pool, with_bits):
    """Pools with remainders in T (5 % 2, 5 % 3) and F (3 % 2)."""
    g = torch.Generator().manual_seed(1)
    B, T, F, Co = 2, 5, 3, 4
    d = dict(dtype=torch.float64, requires_grad=True)
    args = [torch.randn(B, T, F, Co, generator=g, **d),
            (1 + 0.1 * torch.randn(F * Co, generator=g, dtype=torch.float64)).requires_grad_(),
            torch.randn(F * Co, generator=g, **d), torch.randn(Co, Co, generator=g, **d),
            torch.randn(Co, generator=g, **d)]
    bits = torch.randint(0, 256, (B, T, F * Co), generator=g, dtype=torch.uint8) \
        if with_bits else None
    keep = 0.5 if with_bits else 1.0
    fn = lambda *t: fused_cnn.GluDropPool.apply(*t, bits, pool, keep)
    assert torch.autograd.gradcheck(fn, args)
