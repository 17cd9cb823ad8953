"""The port's MixIT objective (training/mixit.py) and separation metrics
(metrics/separation.py) against the JAX package's on seeded inputs, on the
CPU.

Tolerances: the assignment tables equal; losses and SI-SNR values within
1e-5 dB (fp32 sums of 1000-8000 samples in another order) where the
estimates are noisy (SI-SNR below 40 dB); near-perfect estimates, whose
SI-SNR is the rounding noise of a vanishing residual, score above 60 dB on
both sides instead; the best assignment's index equal (a tie keeps the
first on both sides, as a constructed tie checks); gradients of the MixIT
loss within 1e-5 of the largest entry.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from desed_task_tpu.metrics import separation as jsep
from desed_task_tpu.training import mixit as jmix
from desed_task_tpu_torch.metrics import separation as tsep
from desed_task_tpu_torch.training import mixit as tmix

TOL_DB = 1e-5


def _close(a, b, tol=TOL_DB):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0, atol=tol)


@pytest.mark.parametrize("n_src", [2, 3, 4])
def test_assignments_equal(n_src):
    np.testing.assert_array_equal(tmix._assignments(n_src), jmix._assignments(n_src))
    A = tmix.assignments(n_src, "cpu")
    assert A.shape == (2 ** n_src, 2, n_src) and A.dtype == torch.float32


@pytest.mark.parametrize("snr_max", [30.0, 20.0])
def test_neg_thresholded_snr(snr_max):
    r = np.random.default_rng(0)
    t = r.standard_normal((3, 2, 4000)).astype(np.float32)
    e = (t + 0.3 * r.standard_normal(t.shape)).astype(np.float32)
    e[0, 0] = t[0, 0]  # at the cap
    e[1, 1] = 0.0  # nothing estimated
    got = tmix.neg_thresholded_snr(torch.from_numpy(t), torch.from_numpy(e), snr_max)
    _close(got, jmix.neg_thresholded_snr(jnp.asarray(t), jnp.asarray(e), snr_max))


@pytest.mark.parametrize("n_src", [2, 4])
def test_mixit_loss_and_index(n_src):
    r = np.random.default_rng(n_src)
    est = r.standard_normal((5, n_src, 6000)).astype(np.float32)
    mixes = r.standard_normal((5, 2, 6000)).astype(np.float32)
    # example 0 has an exact remix: sources {0, 2, ...} and the rest
    mixes[0, 0] = est[0, ::2].sum(0)
    mixes[0, 1] = est[0, 1::2].sum(0)
    loss, idx = tmix.mixit_loss(torch.from_numpy(est), torch.from_numpy(mixes))
    jloss, jidx = jmix.mixit_loss(jnp.asarray(est), jnp.asarray(mixes))
    _close(loss, jloss)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))


def test_mixit_ties_keep_the_first():
    r = np.random.default_rng(9)
    est = np.zeros((1, 4, 1000), np.float32)
    est[0, 0] = r.standard_normal(1000)
    mixes = np.stack([est[0, 0], np.zeros(1000, np.float32)])[None]
    # sources 1-3 are silent: every assignment that puts source 0 in
    # mixture 0 ties
    _, idx = tmix.mixit_loss(torch.from_numpy(est), torch.from_numpy(mixes))
    _, jidx = jmix.mixit_loss(jnp.asarray(est), jnp.asarray(mixes))
    assert int(idx[0]) == int(jidx[0]) == 0


def test_mixit_loss_gradient():
    r = np.random.default_rng(3)
    est = r.standard_normal((3, 4, 2000)).astype(np.float32)
    mixes = r.standard_normal((3, 2, 2000)).astype(np.float32)
    x = torch.from_numpy(est).requires_grad_(True)
    tmix.mixit_loss(x, torch.from_numpy(mixes))[0].backward()
    g = jax.grad(lambda e: jmix.mixit_loss(e, jnp.asarray(mixes))[0])(jnp.asarray(est))
    g = np.asarray(g)
    _close(x.grad, g, 1e-5 * np.abs(g).max())


def test_mixture_of_mixtures():
    audio = np.random.default_rng(4).standard_normal((6, 300)).astype(np.float32)
    moms, pairs = tmix.mixture_of_mixtures(torch.from_numpy(audio))
    jm, jp = jmix.mixture_of_mixtures(jnp.asarray(audio))
    np.testing.assert_array_equal(pairs.numpy(), np.asarray(jp))
    _close(moms, jm, 0)
    with pytest.raises(ValueError):
        tmix.mixture_of_mixtures(torch.zeros(3, 10))


def test_si_snr():
    r = np.random.default_rng(5)
    t = r.standard_normal((4, 8000)).astype(np.float32)
    noise = r.standard_normal((4, 8000))
    e = np.stack([t[0] + 0.01 * noise[0], 0.1 * t[1] + 0.02 * noise[1],
                  t[2] + 0.3 * noise[2], noise[3]]).astype(np.float32)
    got = tsep.si_snr(torch.from_numpy(t), torch.from_numpy(e))
    _close(got, jsep.si_snr(jnp.asarray(t), jnp.asarray(e)))
    perfect = np.stack([t[0], 0.1 * t[1]])
    for f, arr in ((tsep.si_snr, torch.from_numpy), (jsep.si_snr, jnp.asarray)):
        assert (np.asarray(f(arr(t[:2]), arr(perfect))) > 60).all()


@pytest.mark.parametrize("n_src", [2, 4])
def test_best_assignment_and_si_snri(n_src):
    r = np.random.default_rng(6 + n_src)
    src = r.standard_normal((3, 2, 4000)).astype(np.float32)
    est = (0.01 * r.standard_normal((3, n_src, 4000))).astype(np.float32)
    est[0, n_src - 1] += src[0, 0]
    est[0, 0] += src[0, 1]
    est[1] += src[1, :1]  # every estimate a noisy copy of one source
    mix = src.sum(1)
    s, e, m = (torch.from_numpy(a) for a in (src, est, mix))
    js, je, jm = (jnp.asarray(a) for a in (src, est, mix))
    _close(tsep.best_assignment_si_snr(s, e), jsep.best_assignment_si_snr(js, je))
    _close(tsep.si_snr_improvement(s, e, m), jsep.si_snr_improvement(js, je, jm))
