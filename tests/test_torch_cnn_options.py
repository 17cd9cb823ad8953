"""The CNN's activations and normalizations that no recipe uses, against
the JAX package on the CPU.

Every activation (glu, relu, leakyrelu, cg) with every normalization
("batch", "layer" = GroupNorm(1), and any other string = none) in a narrow
3-block CRNN. Weights come from the JAX model through `from_jax_params`
(strict: each block owns only the modules JAX creates for it). The JAX side
runs its unfused flax chain (`fused_blocks=False`, `rnn_pallas=False`); the
port its defaults, so glu + batch takes its fused blocks (plain versions on
the CPU) and every other block its unfused chain.

  * eval forward in fp32 within 1e-5 of max(1, max |JAX|);
  * train forward (dropout and SpecAugment zeroed; BatchNorm on batch
    statistics) within 1e-5, the running statistics it leaves within 1e-5,
    and the gradients of a seeded linear loss within 1e-4 of the largest
    JAX gradient;
  * bf16 (`compute_dtype`) as tests/test_torch_crnn_bf16.py holds it: the
    port's bf16 scores nearer JAX's bf16 scores than 1/4 of JAX's
    bf16-vs-fp32 gap. A "layer" block differs: flax's GroupNorm returns
    fp32, its statistics are fp32 sums whose order differs between XLA and
    torch (relative 1e-7), and the next conv rounds that fp32 output to
    bf16, where such a difference flips a rounding now and then, which
    then carries through the blocks after it (seeds 0-7: ratio 1e-4 to
    0.568). So a "layer" block is held alone, its fp32 output within
    2e-6 of JAX's (a rounding point missing inside the block, at the
    Dense's operands or output or at the gate, moves it by a bf16 step,
    ~4e-3 relative), the blocks without GroupNorm bitwise, and the whole
    "layer" CRNN nearer JAX's bf16 scores than 3/4 of the bf16-vs-fp32 gap.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from desed_task_tpu.models.cnn import CNN as JaxCNN
from desed_task_tpu.models.crnn import CRNN as JaxCRNN
from desed_task_tpu_torch.models.cnn import CNN, LEAKY_SLOPE_BF16
from desed_task_tpu_torch.models.convert import from_jax_params
from desed_task_tpu_torch.models.crnn import CRNN

N_MELS, T_FR, E, TE = 32, 20, 12, 17
NET = dict(nclass=3, n_RNN_cell=8, n_layers_RNN=1, kernel_size=[3] * 3, padding=[1] * 3,
           stride=[1] * 3, nb_filters=[8, 16, 16], pooling=[[2, 2], [2, 2], [1, 2]],
           dropout=0.0, use_embeddings=True, embedding_size=E, aggregation_type="pool1d",
           specaugm_t_p=0.0, specaugm_f_p=0.0)
ACTS = ("glu", "relu", "leakyrelu", "cg")
NORMS = ("batch", "layer", "none")
COMBOS = [(a, n) for a in ACTS for n in NORMS]
IDS = [f"{a}-{n}" for a, n in COMBOS]


def _perturb(variables, r):
    v = jax.tree_util.tree_map(  # every leaf off its init value
        lambda a: np.asarray(a) + (0.1 * r.standard_normal(a.shape)).astype(np.float32)
        * (1.0 if a.ndim else 0.0), jax.device_get(variables))
    if "batch_stats" in v:
        v["batch_stats"] = jax.tree_util.tree_map(np.abs, v["batch_stats"])
    return v


def _case(act, norm, seed=0):
    r = np.random.default_rng(seed)
    x = (4.0 * r.standard_normal((2, N_MELS, T_FR))).astype(np.float32)
    emb = r.standard_normal((2, E, TE)).astype(np.float32)
    net = dict(NET, activation=act, normalization=norm)
    jm = JaxCRNN(**net, fused_blocks=False, rnn_pallas=False)
    v = _perturb(jm.init(jax.random.key(seed), jnp.asarray(x), embeddings=jnp.asarray(emb)), r)
    return net, x, emb, v


def _port(net, v, **kw):
    tm = CRNN(n_mels=N_MELS, **net, rnn_kernel=False, **kw)
    tm.load_state_dict(from_jax_params(v["params"], v.get("batch_stats")), strict=True)
    return tm


def _close(got, want, tol):
    want = np.asarray(want)
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= tol * max(1.0, float(np.abs(want).max()))


@pytest.mark.parametrize("act,norm", COMBOS, ids=IDS)
def test_eval_forward_matches_jax(act, norm):
    net, x, emb, v = _case(act, norm)
    sj, wj = JaxCRNN(**net, fused_blocks=False, rnn_pallas=False).apply(
        v, jnp.asarray(x), embeddings=jnp.asarray(emb))
    tm = _port(net, v).eval()
    assert tm.cnn._is_fused(0) == (act == "glu" and norm == "batch")
    with torch.no_grad():
        s, w = tm(torch.from_numpy(x), embeddings=torch.from_numpy(emb))
    _close(s.numpy(), sj, 1e-5)
    _close(w.numpy(), wj, 1e-5)


@pytest.mark.parametrize("act,norm", COMBOS, ids=IDS)
def test_train_forward_and_gradients_match_jax(act, norm):
    net, x, emb, v = _case(act, norm, seed=3)
    r = np.random.default_rng(11)
    cs = r.standard_normal((2, 3, 5)).astype(np.float32)
    cw = r.standard_normal((2, 3)).astype(np.float32)
    jm = JaxCRNN(**net, fused_blocks=False, rnn_pallas=False)
    rest = {k: val for k, val in v.items() if k != "params"}

    def loss(params):
        (s, w), upd = jm.apply({"params": params, **rest}, jnp.asarray(x),
                               embeddings=jnp.asarray(emb), train=True,
                               mutable=["batch_stats"], rngs={"dropout": jax.random.key(1),
                                                              "augment": jax.random.key(2)})
        return jnp.sum(s * cs) + jnp.sum(w * cw), (s, w, upd)

    (_, (sj, wj, upd)), gj = jax.value_and_grad(loss, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, v["params"]))
    tm = _port(net, v).train()
    s, w = tm(torch.from_numpy(x), embeddings=torch.from_numpy(emb))
    _close(s.detach().numpy(), sj, 1e-5)
    _close(w.detach().numpy(), wj, 1e-5)
    ((s * torch.from_numpy(cs)).sum() + (w * torch.from_numpy(cw)).sum()).backward()
    want = from_jax_params(jax.device_get(gj))
    got = dict(tm.named_parameters())
    assert set(want) == set(got)
    scale = max(float(g.abs().max()) for g in want.values())
    for name, g in want.items():
        assert float((got[name].grad - g).abs().max()) <= 1e-4 * scale, name
    stats = from_jax_params({}, jax.device_get(upd.get("batch_stats", {})))
    assert bool(stats) == (norm == "batch")
    buffers = dict(tm.named_buffers())
    for name, val in stats.items():
        _close(buffers[name].numpy(), val.numpy(), 1e-5)


def _bf16_gap(act, norm, seed):
    """(port bf16 vs JAX bf16, JAX bf16 vs JAX fp32): max |diff| of the
    strong and of the weak scores."""
    net, x, emb, v = _case(act, norm, seed)
    kw = dict(fused_blocks=False, rnn_pallas=False)
    sj, wj = JaxCRNN(**net, **kw, compute_dtype=jnp.bfloat16).apply(
        v, jnp.asarray(x), embeddings=jnp.asarray(emb))
    sf, wf = JaxCRNN(**net, **kw).apply(v, jnp.asarray(x), embeddings=jnp.asarray(emb))
    # glu + batch unfused too: its fused bf16 blocks round as JAX's fused
    # blocks do, which tests/test_torch_crnn_bf16.py holds
    tm = _port(net, v, compute_dtype=torch.bfloat16, fused_blocks=False).eval()
    with torch.no_grad():
        s, w = tm(torch.from_numpy(x), embeddings=torch.from_numpy(emb))
    assert s.dtype == w.dtype == torch.float32  # the RNN and heads stay fp32
    return [(float(np.abs(p.numpy() - np.asarray(ref)).max()),
             float(np.abs(np.asarray(ref) - np.asarray(f32)).max()))
            for p, ref, f32 in ((s, sj, sf), (w, wj, wf))]


# a "layer" CRNN on each of the 8 seeds whose ratios were measured
BF16_CASES = [(a, n, s) for a, n in COMBOS for s in (range(8) if n == "layer" else (0,))]


@pytest.mark.parametrize("act,norm,seed", BF16_CASES,
                         ids=[f"{a}-{n}-{s}" for a, n, s in BF16_CASES])
def test_bf16_crnn_matches_jax_bf16(act, norm, seed):
    """Measured ratios: 0 to 1e-3 without GroupNorm (seed 0); with it 1e-4
    to 0.568, the largest glu on seed 2 (strong 0.532, weak 0.568)."""
    limit = 0.75 if norm == "layer" else 0.25
    for gap, precision_gap in _bf16_gap(act, norm, seed):
        assert precision_gap > 1e-4  # the bf16 model is not the fp32 one
        assert gap <= limit * precision_gap


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("norm", NORMS)
def test_bf16_block_matches_jax(act, norm):
    """One unfused block in bf16: bitwise without GroupNorm (bf16 out); with
    it the block's fp32 output within 2e-6 of JAX's (measured 2.4e-7)."""
    r = np.random.default_rng(5)
    x = (3.0 * r.standard_normal((2, 12, 16, 4))).astype(np.float32)
    kw = dict(activation=act, normalization=norm, kernel_size=[3], padding=[1], stride=[1],
              nb_filters=[8], pooling=[[2, 2]])
    jm = JaxCNN(**kw, fused_blocks=False, dtype=jnp.bfloat16)
    v = _perturb(jm.init(jax.random.key(4), jnp.asarray(x)), r)
    zj = jm.apply(v, jnp.asarray(x))
    tm = CNN(n_in_channel=4, **kw, fused_blocks=False, compute_dtype=torch.bfloat16).eval()
    tm.load_state_dict(from_jax_params(v["params"], v.get("batch_stats")), strict=True)
    with torch.no_grad():
        z = tm(torch.from_numpy(x))
    if norm == "layer":
        assert zj.dtype == jnp.float32 and z.dtype == torch.float32
        _close(z.numpy(), zj, 2e-6)
    else:
        assert zj.dtype == jnp.bfloat16 and z.dtype == torch.bfloat16
        assert np.array_equal(z.float().numpy(), np.asarray(zj.astype(jnp.float32)))


def test_leaky_slope_is_the_bf16_scalar():
    assert LEAKY_SLOPE_BF16 == float(jnp.asarray(0.2, jnp.bfloat16))


def test_unknown_activation_raises():
    with pytest.raises(ValueError, match="activation"):
        CNN(activation="tanh")


def test_each_block_owns_only_the_jax_modules():
    """relu / leakyrelu own no Linear; an unknown normalization owns
    nothing; the module names are the flax tree's."""
    for act, norm, want in (("relu", "batch", {"conv0", "batchnorm0"}),
                            ("leakyrelu", "layer", {"conv0", "layernorm0"}),
                            ("cg", "none", {"conv0", "cg0"}),
                            ("glu", "instance", {"conv0", "glu0"})):
        cnn = CNN(activation=act, normalization=norm, nb_filters=[4], kernel_size=[3],
                  padding=[1], stride=[1], pooling=[[1, 2]])
        assert {n for n, _ in cnn.named_children()} == want


@pytest.mark.parametrize("packed", [True, False])
def test_conv_dropout_distribution(packed):
    """Unfused train-mode conv dropout: with packed_dropout the uint8 bytes
    the fused block draws (the same elements from the same generator
    state), without it nn.Dropout's Bernoulli(1 - rate) mask; kept
    elements scaled by 1 / keep either way."""
    rate = 0.25
    cnn = CNN(activation="relu", normalization="none", conv_dropout=rate, nb_filters=[16],
              kernel_size=[3], padding=[1], stride=[1], pooling=[[1, 1]],
              packed_dropout=packed).train()
    with torch.no_grad():
        cnn.conv0.weight.zero_()
        cnn.conv0.bias.fill_(1.0)  # relu(conv) == 1 everywhere
    x = torch.zeros(8, 64, 32, 1)
    z = cnn(x, generator=torch.Generator().manual_seed(0))
    vals = set(torch.unique(z).tolist())
    assert vals == {0.0, float(np.float32(1.0 / (1.0 - rate)))}
    dropped = float((z == 0).float().mean())
    assert abs(dropped - rate) < 0.01  # 262144 draws: 4 sigma is 0.0034
    g = torch.Generator().manual_seed(0)
    packed_mask = torch.randint(0, 256, (8, 64, 32 * 16), dtype=torch.uint8, generator=g)
    same = torch.equal((z != 0).view(8, 64, -1), packed_mask.to(torch.int32) < 192)
    assert same == packed
