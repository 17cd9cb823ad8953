"""The port's augmentations against the JAX module on the same draws, and
their distributions (and dropout's keep rates) from a torch.Generator.

JAX's draws are rebuilt here from its keys exactly as desed_task_tpu/ops/
augment.py splits them, then handed to the port. Same draws, same float32
arithmetic: masks and rolls must be equal; mixed values within 1e-6.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from desed_task_tpu.ops import augment as jaug
from desed_task_tpu_torch.ops import augment as aug
from desed_task_tpu_torch.ops.dropout import dropout, packed_keep_mask


def _mel(seed=0, shape=(4, 16, 40)):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32) + 3.0


def _time_mask_draws(key, b):
    k1, k2 = jax.random.split(key)
    return torch.from_numpy(np.stack([np.asarray(jax.random.uniform(k1, (b,))),
                                      np.asarray(jax.random.uniform(k2, (b,)))]))


@pytest.mark.parametrize("axis,mask_param,p,shared", [
    (2, 5, 1.0, False), (1, 10, 0.2, False), (2, 16, 0.3, False), (1, 10, 1.0, True)])
def test_time_mask_matches_jax(axis, mask_param, p, shared):
    x = _mel()
    for seed in range(3, 20):  # a key whose draws mask at least one position
        key = jax.random.key(seed)
        want = np.asarray(jaug.time_mask(key, jnp.asarray(x), mask_param, p, axis=axis,
                                         shared=shared))
        if (want == 0).any():
            break
    u = _time_mask_draws(key, 1 if shared else x.shape[0])
    got = aug.time_mask(None, torch.from_numpy(x), mask_param, p, axis=axis, shared=shared, u=u)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want == 0).any()  # the comparison covered a mask


def test_specaugment_matches_jax():
    x = _mel(1)
    key = jax.random.key(4)
    want = np.asarray(jaug.specaugment(key, jnp.asarray(x), 5, 0.2, 10, 0.2))
    k1, k2 = jax.random.split(key)
    u = (_time_mask_draws(k1, 4), _time_mask_draws(k2, 4))
    got = aug.specaugment(None, torch.from_numpy(x), 5, 0.2, 10, 0.2, u=u)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("label_type", ["soft", "hard"])
def test_mixup_matches_jax(label_type):
    r = np.random.default_rng(2)
    x = r.standard_normal((6, 8, 10)).astype(np.float32)
    t = (r.random((6, 3, 10)) > 0.6).astype(np.float32)
    perm = r.permutation(6)
    c = np.float32(0.3125)
    xj, tj, _ = jaug.mixup(jax.random.key(0), jnp.asarray(x), jnp.asarray(t),
                           mixup_label_type=label_type, perm=jnp.asarray(perm),
                           c=jnp.asarray(c))
    xt, tt, _ = aug.mixup(None, torch.from_numpy(x), torch.from_numpy(t),
                          mixup_label_type=label_type, perm=torch.from_numpy(perm), c=float(c))
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), rtol=0, atol=1e-6)


def test_frame_shift_matches_jax():
    r = np.random.default_rng(3)
    x = _mel(3)
    labels = r.random((4, 3, 10)).astype(np.float32)
    key = jax.random.key(5)
    mj, lj = jaug.frame_shift(key, jnp.asarray(x), jnp.asarray(labels), 4, 9.0)
    noise = torch.from_numpy(np.array(jax.random.normal(key, (4,))))
    mt, lt = aug.frame_shift(None, torch.from_numpy(x), torch.from_numpy(labels), 4, 9.0,
                             noise=noise)
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))


def test_add_noise_matches_jax():
    x = _mel(4)
    key = jax.random.key(6)
    want = np.asarray(jaug.add_noise(key, jnp.asarray(x)))
    k1, k2 = jax.random.split(key)
    u = torch.from_numpy(np.array(jax.random.uniform(k1, (4, 1, 1))))
    noise = torch.from_numpy(np.array(jax.random.normal(k2, x.shape)))
    got = aug.add_noise(None, torch.from_numpy(x), u=u, noise=noise)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_time_mask_distribution():
    """Float lengths U[0, 20) (mean 10 masked positions) and starts
    U[0, 100 - length) (mean 45), one mask per example."""
    g = torch.Generator().manual_seed(0)
    x = torch.ones(4000, 1, 100)
    m = aug.time_mask(g, x, 20, 1.0, axis=2) == 0
    n_masked = m.sum(-1).float().squeeze(1)
    assert n_masked.max() <= 20
    assert abs(float(n_masked.mean()) - 10.0) < 0.5
    has = n_masked > 0
    starts = m.float().argmax(-1).squeeze(1)[has].float()
    assert abs(float(starts.mean()) - 45.0) < 2.0
    runs = (m[..., 1:] & ~m[..., :-1]).sum(-1)  # contiguous: at most one run start
    assert int(runs.max()) <= 1


def test_mixup_and_frame_shift_distributions():
    g = torch.Generator().manual_seed(1)
    cs = [aug.mixup(g, torch.zeros(4, 2))[1][1] for _ in range(400)]
    # Beta(0.2, 0.2): mean 0.5, variance 0.04 / (0.16 * 1.4) = 0.179
    assert abs(np.mean(cs) - 0.5) < 0.06 and abs(np.var(cs) - 0.179) < 0.03
    x = torch.arange(4000, dtype=torch.float32).repeat(2000, 1)[:, None, :]
    shifted, _ = aug.frame_shift(g, x, torch.zeros(2000, 1, 1000), std=90.0)
    s = (-shifted[:, 0, 0]) % 4000  # rolled[0] = x[-shift mod n]
    s = torch.where(s > 2000, s - 4000, s)
    assert abs(float(s.mean())) < 6.0 and abs(float(s.std()) - 90.0) < 6.0


@pytest.mark.parametrize("keep", [0.5, 0.7])
def test_packed_keep_mask_rate(keep):
    g = torch.Generator().manual_seed(2)
    m = packed_keep_mask((200_000,), keep, g)
    want = round(keep * 256) / 256  # quantized to 8 bits (exact at 0.5)
    assert abs(float(m.float().mean()) - want) < 0.005
    assert packed_keep_mask((3,), 1.0, g).all()


def test_dropout_keep_rate_and_scale():
    g = torch.Generator().manual_seed(3)
    x = torch.ones(200_000)
    y = dropout(x, 0.3, g, train=True)
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.7) < 0.005
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / 0.7))
    assert dropout(x, 0.3, g, train=False) is x
    with pytest.raises(ValueError):
        dropout(x, 0.3, None, train=True)
