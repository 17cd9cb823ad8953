"""Port fused conv block (plain versions on the CPU) against the JAX Pallas
kernels in interpret mode, on the same numpy inputs."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from desed_task_tpu.ops import pallas_cnn
from desed_task_tpu_torch.ops import fused_cnn

# (B, T, F, Ci, Co, pool): Ci=1 as the first 2024 block, T not a multiple of 8
GEOMS = [
    (2, 13, 16, 1, 8, (2, 2)),
    (2, 10, 8, 8, 16, (1, 2)),
]


def _block_inputs(B, T, F, Ci, Co, seed=0):
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


def _t(d):
    return {k: torch.from_numpy(v) for k, v in d.items()}


@pytest.mark.parametrize("geom", GEOMS)
def test_conv_bn_stats_plain_matches_jax(geom):
    B, T, F, Ci, Co, pool = geom
    a = _block_inputs(B, T, F, Ci, Co)
    dims = pallas_cnn.BlockDims(B, T, F, Ci, Co, *pool, dtype="float32")
    xpad = jnp.pad(jnp.asarray(a["x"]).reshape(B, T, F * Ci),
                   ((0, 0), (1, 1 + dims.Tp - T), (Ci, Ci)))
    yj, sj, qj = pallas_cnn.conv_bn_stats(xpad, jnp.asarray(a["w"]),
                                          jnp.asarray(a["bias"]), dims, True)
    y, s, q = fused_cnn.conv_bn_stats_plain(*(torch.from_numpy(a[k]) for k in ("x", "w", "bias")))
    assert y.shape == (B, T, F, Co)
    # fp32 sums of 9*Ci products in another order
    np.testing.assert_allclose(y.numpy().reshape(B, T, F * Co), np.asarray(yj)[:, :T],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(s.numpy(), np.asarray(sj), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(q.numpy(), np.asarray(qj), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("fpool", [True, False])
@pytest.mark.parametrize("with_bits,keep", [(False, 1.0), (True, 1.0), (True, 0.5)])
def test_glu_drop_pool_plain_matches_jax(fpool, with_bits, keep):
    B, T, F, Co, pt, pf = 2, 13, 16, 8, 2, 2  # the TPU kernel needs F*Co >= 128
    r = np.random.default_rng(1)
    dims = pallas_cnn.BlockDims(B, T, F, 1, Co, pt, pf, dtype="float32")
    L = F * Co
    y = r.standard_normal((B, dims.Tp, L)).astype(np.float32)
    scale_f = (1.0 + 0.1 * r.standard_normal(L)).astype(np.float32)
    bias_f = (0.1 * r.standard_normal(L)).astype(np.float32)
    wg = (r.standard_normal((Co, Co)) * 0.3).astype(np.float32)
    bg = (r.standard_normal(Co) * 0.1).astype(np.float32)
    bits = r.integers(0, 256, (B, dims.Tp, L), dtype=np.uint8) if with_bits else None
    zj = pallas_cnn.glu_drop_pool(
        jnp.asarray(y), jnp.asarray(scale_f)[None], jnp.asarray(bias_f)[None],
        jnp.asarray(wg), jnp.asarray(bg), None if bits is None else jnp.asarray(bits),
        dims, keep, True, fpool)
    Fo = F // pf if fpool else F
    zj = np.asarray(zj)[:, : T // pt].reshape(B, T // pt, Fo, Co)
    z = fused_cnn.glu_drop_pool_plain(
        torch.from_numpy(y[:, :T].reshape(B, T, F, Co)), torch.from_numpy(scale_f),
        torch.from_numpy(bias_f), torch.from_numpy(wg), torch.from_numpy(bg),
        None if bits is None else torch.from_numpy(np.ascontiguousarray(bits[:, :T])),
        pool=(pt, pf if fpool else 1), keep_prob=keep)
    assert z.shape == zj.shape
    np.testing.assert_allclose(z.numpy(), zj, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("geom", GEOMS)
@pytest.mark.parametrize("train,rate", [(False, 0.0), (True, 0.0), (True, 0.5)])
def test_fused_glu_block_matches_jax(geom, train, rate):
    """Eval, train-mode forward (new running stats) and train with dropout
    given the JAX kernel's own uint8 bits."""
    B, T, F, Ci, Co, pool = geom
    a = _block_inputs(B, T, F, Ci, Co, seed=2)
    key = jax.random.key(5)
    zj, mj, vj = pallas_cnn.fused_glu_block(
        *(jnp.asarray(a[k]) for k in a), pool=pool, train=train,
        dropout_rate=rate, dropout_key=key if rate else None, interpret=True,
        fpool_in_kernel=True)
    bits = None
    if rate:
        dims = pallas_cnn.BlockDims(B, T, F, Ci, Co, *pool)
        bits = torch.from_numpy(np.ascontiguousarray(
            np.asarray(jax.random.bits(key, (B, dims.Tp, dims.Lout), jnp.uint8))[:, :T]))
    z, m, v = fused_cnn.fused_glu_block(
        **_t(a), pool=pool, train=train, dropout_rate=rate, bits=bits)
    assert z.shape == zj.shape
    np.testing.assert_allclose(z.numpy(), np.asarray(zj), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(m.numpy(), np.asarray(mj), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(v.numpy(), np.asarray(vj), rtol=1e-5, atol=1e-6)


def test_wrappers_take_plain_version_on_cpu():
    a = _t(_block_inputs(2, 5, 4, 3, 4))
    y, s, q = fused_cnn.conv_bn_stats(a["x"], a["w"], a["bias"])
    yp, sp, qp = fused_cnn.conv_bn_stats_plain(a["x"], a["w"], a["bias"])
    assert torch.equal(y, yp) and torch.equal(s, sp) and torch.equal(q, qp)
