"""Port class-wise median filter against both JAX functions: odd and even
windows, scipy 'reflect' edges (the edge sample repeats)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from desed_task_tpu.ops import median as jmed
from desed_task_tpu_torch.ops import median as tmed

WINDOWS = [
    [3, 5, 7, 1],  # odd
    [2, 4, 6, 8],  # even: mean of the two middle values
    [1, 4, 9, 12],  # mixed, 12 > T/2
]


@pytest.mark.parametrize("windows", WINDOWS)
def test_matches_both_jax_functions(windows):
    r = np.random.default_rng(0)
    x = r.random((2, 4, 11)).astype(np.float32)
    j = np.asarray(jmed.classwise_median_filter(jnp.asarray(x), windows))
    j_np = jmed.classwise_median_filter_np(x, windows)
    t = tmed.classwise_median_filter(torch.from_numpy(x), windows).numpy()
    t_np = tmed.classwise_median_filter_np(x, windows)
    # medians select inputs; even windows average two of them in fp32
    np.testing.assert_allclose(t, j, rtol=0, atol=1e-7)
    np.testing.assert_allclose(t, j_np, rtol=0, atol=1e-7)
    np.testing.assert_allclose(t_np, j_np, rtol=0, atol=0)


def test_time_and_class_axes():
    r = np.random.default_rng(1)
    x = r.random((5, 20, 3)).astype(np.float32)  # [B, T, C]
    w = [3, 4, 5]
    j = np.asarray(jmed.classwise_median_filter(jnp.asarray(x), w, class_axis=-1, time_axis=-2))
    t = tmed.classwise_median_filter(torch.from_numpy(x), w, class_axis=-1, time_axis=-2)
    np.testing.assert_allclose(t.numpy(), j, rtol=0, atol=1e-7)
