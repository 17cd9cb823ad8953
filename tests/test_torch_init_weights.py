"""`init_weights` draws conv and dense kernels as flax `lecun_normal` does:
a normal truncated at +-2 std (std = 1/sqrt(fan_in)/0.8796), not a normal
clamped at +-2 std, which would put ~4.6 % of the entries on the bounds."""

import math

import numpy as np
import torch

import jax

from desed_task_tpu_torch.models.crnn import CRNN, init_weights


def _model():
    return CRNN(nclass=128, n_RNN_cell=64, n_layers_RNN=1, kernel_size=[3], padding=[1],
                stride=[1], nb_filters=[16], pooling=[[1, 2]], n_mels=8,
                attention=False)


def test_kernels_are_truncated_not_clamped():
    model = init_weights(_model(), torch.Generator().manual_seed(0))
    w = model.dense.weight.detach().numpy()  # [128, 2*64] -> fan_in 128
    fan_in = w.shape[1]
    sigma = 1.0 / math.sqrt(fan_in) / 0.87962566103423978  # the pre-truncation std
    a = np.abs(w)
    assert a.max() <= 2 * sigma * (1 + 1e-6)
    # a clamp puts 4.55 % exactly on +-2 sigma; a truncated normal has 0.1 %
    # of its mass in [1.99, 2] sigma
    assert float((a >= 1.99 * sigma).mean()) < 0.005
    assert float((a >= 2 * sigma * (1 - 1e-6)).mean()) < 1e-3


def test_std_matches_flax_lecun_normal():
    model = init_weights(_model(), torch.Generator().manual_seed(1))
    w = model.dense.weight.detach().numpy()
    ref = np.asarray(jax.nn.initializers.lecun_normal()(jax.random.key(0), (128, 128)))
    assert abs(w.std() / ref.std() - 1.0) < 0.03
    assert abs(w.std() * math.sqrt(128) - 1.0) < 0.03  # variance 1 / fan_in
    conv = model.cnn.conv0.weight.detach().numpy()  # fan_in 9
    assert abs(conv.std() * 3.0 - 1.0) < 0.15  # 144 entries
    assert float(model.dense.bias.detach().abs().max()) == 0.0
