"""The port's BEATs pretraining (training/beats_pretrain.py) against
desed_task_tpu/training/beats_pretrain.py on the CPU, at a small BEATs (2
layers, 64 wide) on 1-s clips (48 tokens), weights carried across by
`from_jax_embedder_params`, the same mask handed to both sides.

Tolerances: `patch_targets` and `n_tokens_for` exactly; the masked-patch
loss within 1e-5 relative in fp32 and its gradients within 1e-4 of each
tensor's largest entry (fp32, sums in another order), above a floor of
1e-7 of the largest gradient overall for the attention's k bias, whose
exact gradient is 0 (softmax does not see a constant added to a row: both
sides give noise); in bf16 the port's loss within 1e-4 relative of JAX's
bf16 loss (a mean over ~15k masked pixels, whose bf16 roundings average
out; JAX's own bf16-vs-fp32 gap there is 1e-5 to 1e-3, depending on the
draw) and its gradients no farther from JAX's bf16 ones than JAX's bf16
are from JAX's fp32 (relative L2 norm over all gradients); the parameters
after two AdamW steps (the first at lr 0, so it changes nothing) within
1e-6 absolute of optax's (2e-3 of the second step's lr), but the k bias,
which Adam's normalisation moves by up to the lr either way on both sides
(its noise gradient); the schedule within 2e-5 relative of optax's (optax
computes the warmup as (0 - lr) (1 - count / warmup) + lr in float32,
1.5e-5 off at count 1). Then
`pretrain_beats` and `finetune_beats_weak` (a 1-layer, 32-wide BEATs, 8
steps each) on 6 seeded wavs: finite losses that fall, exact mask counts,
and a saved file that loads through `build_embedder` and embeds.
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from desed_task_tpu.models import beats as jb
from desed_task_tpu.training import beats_pretrain as jp
from desed_task_tpu_torch.data.audio_io import write_wav
from desed_task_tpu_torch.models import beats as tb
from desed_task_tpu_torch.models.convert import from_jax_embedder_params
from desed_task_tpu_torch.training import beats_pretrain as tp

SMALL = dict(embed_dim=32, encoder_layers=2, encoder_embed_dim=64, encoder_ffn_embed_dim=128,
             encoder_attention_heads=4, conv_pos=16, conv_pos_groups=4, num_buckets=32,
             max_distance=64)
TINY = dict(SMALL, encoder_layers=1, encoder_embed_dim=32, embed_dim=16, encoder_ffn_embed_dim=32,
            encoder_attention_heads=2, conv_pos=8, conv_pos_groups=2)
N = 16000
N_TOK = 48


def _audio(seed, B=2):
    return (np.random.default_rng(seed).standard_normal((B, N)) * 0.1).astype(np.float32)


def _mask(seed, B=2):
    r = np.random.default_rng(seed)
    m = np.zeros((B, N_TOK), bool)
    for b in range(B):
        m[b, r.permutation(N_TOK)[: round(0.6 * N_TOK)]] = True
    return m


@pytest.fixture(scope="module")
def pair():
    cfg = jb.BEATsConfig(**SMALL)
    model = jb.BEATsEncoder(cfg)
    fb = jp.beats_preprocess(jnp.zeros((1, N), jnp.float32))
    shapes = jax.eval_shape(model.init, jax.random.key(0), fb,
                            mask_indices=jnp.zeros((1, N_TOK), bool))["params"]
    r = np.random.default_rng(1)

    def value(path, s):  # LayerNorm scales, weight_g and grep_a near 1, the rest small
        near_one = path[-1].key in ("scale", "weight_g", "grep_a")
        v = (1.0 if near_one else 0.0) + 0.05 * r.standard_normal(s.shape)
        if path[-1].key == "kernel":
            v = r.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))
        return v.astype(np.float32)

    params = jax.tree_util.tree_map_with_path(value, shapes)
    head = {"kernel": (0.02 * r.standard_normal((64, 256))).astype(np.float32),
            "bias": (0.01 * r.standard_normal(256)).astype(np.float32)}
    return model, params, head


def _loss_fn(model, cdt):
    def loss_fn(trainable, audio, mask):
        p, h = trainable
        if cdt != jnp.float32:
            p = jax.tree.map(lambda a: a.astype(cdt) if a.dtype == jnp.float32 else a, p)
        return jp.masked_patch_loss(model, p, audio, mask, h, compute_dtype=cdt).astype(
            jnp.float32)

    return loss_fn


@pytest.fixture(scope="module")
def jax_runs(pair):
    """JAX's loss and gradients in fp32 and in bf16 on the same inputs."""
    model, params, head = pair
    audio, mask = jnp.asarray(_audio(3)), jnp.asarray(_mask(4))
    out = {}
    for name, cdt in (("fp32", jnp.float32), ("bf16", jnp.bfloat16)):
        loss, (gp, gh) = jax.jit(jax.value_and_grad(_loss_fn(model, cdt)))(
            (params, head), audio, mask)
        out[name] = (float(loss), from_jax_embedder_params(jax.device_get(gp)),
                     np.asarray(gh["kernel"]).T)
    return out


def _port(params, head):
    enc = tb.BEATsEncoder(tb.BEATsConfig(**SMALL), mask_token=True)
    enc.load_state_dict(from_jax_embedder_params(params), strict=True)
    lin = torch.nn.Linear(64, 256)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(head["kernel"].T.copy()))
        lin.bias.copy_(torch.from_numpy(head["bias"]))
    return enc.train(), lin


def test_patch_targets_order_matches_jax():
    fb = np.random.default_rng(2).standard_normal((2, 98, 128)).astype(np.float32)
    got = tp.patch_targets(torch.from_numpy(fb), 16).numpy()
    want = np.asarray(jp.patch_targets(jnp.asarray(fb), 16))
    assert got.shape == want.shape == (2, 48, 256)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0, 9], fb[0, 16:32, 16:32].reshape(-1))  # token (1, 1)


@pytest.mark.parametrize("n", [16000, 32000, 160000, 12345])
def test_n_tokens_for_matches_jax(n):
    assert tp.n_tokens_for(tb.BEATsConfig(), n) == jp.n_tokens_for(jb.BEATsConfig(), n)
    assert tp.n_tokens_for(tb.BEATsConfig(), 160000) == 496


def _port_loss_and_grads(params, head, audio, mask, cdt):
    enc, lin = _port(params, head)
    loss = tp.masked_patch_loss(enc, torch.from_numpy(audio), torch.from_numpy(mask), lin, cdt)
    loss.backward()
    grads = {n: p.grad for n, p in enc.named_parameters()}
    return float(loss.detach()), grads, lin.weight.grad.numpy()


def test_masked_patch_loss_and_grads_match_jax_fp32(pair, jax_runs):
    _, params, head = pair
    audio, mask = _audio(3), _mask(4)
    lj, gj, hj = jax_runs["fp32"]
    lt, gt, ht = _port_loss_and_grads(params, head, audio, mask, torch.float32)
    np.testing.assert_allclose(lt, lj, rtol=1e-5)
    assert set(gt) == set(gj)
    top = max(float(g.abs().max()) for g in gj.values())
    for name, want in gj.items():
        floor = 1e-7 * top if name.endswith("k_proj.bias") else 0.0
        torch.testing.assert_close(gt[name], want, rtol=0,
                                   atol=max(1e-4 * float(want.abs().max()), floor), msg=name)
    np.testing.assert_allclose(ht, hj, rtol=0, atol=1e-4 * np.abs(hj).max())


def test_masked_patch_loss_and_grads_match_jax_bf16(pair, jax_runs):
    _, params, head = pair
    audio, mask = _audio(3), _mask(4)
    l32, g32, h32 = jax_runs["fp32"]
    l16, g16, h16 = jax_runs["bf16"]
    lt, gt, ht = _port_loss_and_grads(params, head, audio, mask, torch.bfloat16)
    assert all(g.dtype == torch.float32 for g in gt.values())  # the fp32 masters' gradients
    np.testing.assert_allclose(lt, l16, rtol=1e-4)
    flat = lambda g, h: np.concatenate([*(v.numpy().ravel() for v in g.values()), h.ravel()])
    j16, j32 = flat(g16, h16), flat(g32, h32)
    t16 = np.concatenate([*(gt[k].numpy().ravel() for k in g16), ht.ravel()])
    gap = np.linalg.norm(j16 - j32) / np.linalg.norm(j32)
    assert gap > 0
    assert np.linalg.norm(t16 - j16) / np.linalg.norm(j32) <= gap, gap


def test_two_adamw_steps_match_optax(pair):
    """Step 1 at lr 0 changes nothing; step 2 at schedule(1)."""
    model, params, head = pair
    cfg_t = tp.BEATsPretrainConfig(beats=tb.BEATsConfig(**SMALL), lr=1e-3, warmup_steps=2,
                                   steps=10, batch_size=2)
    audio = _audio(5, B=4)
    store = torch.from_numpy(np.clip(audio * 32768, -32768, 32767).astype(np.int16))
    masks = [_mask(6), _mask(7)]
    idx = [np.array([0, 2]), np.array([3, 1])]

    schedule = optax.warmup_cosine_decay_schedule(0.0, 1e-3, 2, 10)
    tx = optax.adamw(schedule, weight_decay=cfg_t.weight_decay)
    trainable = (jax.tree_util.tree_map(jnp.asarray, params),
                 jax.tree_util.tree_map(jnp.asarray, head))
    opt_state = tx.init(trainable)
    store_j = jnp.asarray(store.numpy())
    grad_fn = jax.jit(jax.grad(_loss_fn(model, jnp.float32)))
    for i in range(2):
        a = store_j[idx[i]].astype(jnp.float32) / 32768.0
        grads = grad_fn(trainable, a, jnp.asarray(masks[i]))
        updates, opt_state = tx.update(grads, opt_state, trainable)
        trainable = optax.apply_updates(trainable, updates)

    enc, lin = _port(params, head)
    before = {k: v.clone() for k, v in enc.state_dict().items()}
    opt = tp.make_optimizer([*enc.parameters(), *lin.parameters()], cfg_t)
    step = tp.make_pretrain_step(enc, lin, cfg_t, opt, N_TOK)
    for i in range(2):
        loss, _ = step(store, torch.from_numpy(idx[i]), None, torch.from_numpy(masks[i]))
        assert np.isfinite(float(loss))
        if i == 0:
            assert all(torch.equal(v, before[k]) for k, v in enc.state_dict().items())
    want = from_jax_embedder_params(jax.device_get(trainable[0]))
    lr = tp.warmup_cosine(cfg_t)(1)
    for name, p in enc.state_dict().items():
        if name.endswith("k_proj.bias"):  # noise gradient: a step of up to lr either way
            assert float((p - before[name]).abs().max()) <= 1.01 * lr, name
            assert float((want[name] - before[name]).abs().max()) <= 1.01 * lr, name
            continue
        torch.testing.assert_close(p, want[name], rtol=0, atol=1e-6, msg=name)
    np.testing.assert_allclose(lin.weight.detach().numpy(),
                               np.asarray(trainable[1]["kernel"]).T, rtol=0, atol=1e-6)
    moved = max(float((p - before[n]).abs().max()) for n, p in enc.state_dict().items())
    assert moved > 1e-4  # step 2 moved the weights (by ~lr 5e-4)


def test_warmup_cosine_matches_optax():
    cfg = tp.BEATsPretrainConfig(lr=5e-4, warmup_steps=250, steps=3000)
    want = optax.warmup_cosine_decay_schedule(0.0, 5e-4, 250, 3000)
    sched = tp.warmup_cosine(cfg)
    for c in (0, 1, 100, 249, 250, 251, 1000, 2999, 3000, 3500):
        np.testing.assert_allclose(sched(c), float(want(c)), rtol=2e-5, atol=1e-12)
    short = tp.warmup_cosine(tp.BEATsPretrainConfig(warmup_steps=5, steps=3))
    np.testing.assert_allclose(short(5), float(optax.warmup_cosine_decay_schedule(
        0.0, 5e-4, 5, 6)(5)), rtol=1e-6)


def test_mask_draw_takes_exact_counts():
    enc = tb.init_beats(tb.BEATsEncoder(tb.BEATsConfig(**SMALL), mask_token=True),
                        torch.Generator().manual_seed(0))
    lin = torch.nn.Linear(64, 256)
    cfg = tp.BEATsPretrainConfig(beats=tb.BEATsConfig(**SMALL), warmup_steps=1, steps=2)
    step = tp.make_pretrain_step(enc, lin, cfg, tp.make_optimizer(enc.parameters(), cfg), N_TOK)
    store = torch.zeros(3, N, dtype=torch.int16)
    _, mask = step(store, torch.tensor([0, 1, 2]), torch.Generator().manual_seed(3))
    assert mask.shape == (3, N_TOK) and mask.sum(-1).tolist() == [29, 29, 29]


@pytest.fixture(scope="module")
def wavs(tmp_path_factory):
    root = tmp_path_factory.mktemp("beats_wavs")
    r = np.random.default_rng(8)
    paths = []
    for i in range(6):
        t = np.arange(N) / 16000
        x = 0.3 * np.sin(2 * np.pi * (300 + 200 * i) * t) + 0.02 * r.standard_normal(N)
        write_wav(root / f"clip_{i}.wav", x.astype(np.float32), 16000)
        paths.append(root / f"clip_{i}.wav")
    return paths


@pytest.fixture
def two_threads():
    """Two intra-op threads: this test's many small ops then do not wait on
    the other test workers' threads (restored after)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield
    finally:
        torch.set_num_threads(prev)


def test_pretrain_then_finetune_and_load(wavs, tmp_path, two_threads):
    from desed_task_tpu_torch.tools.embeddings import build_embedder

    cfg = tp.BEATsPretrainConfig(beats=tb.BEATsConfig(**TINY), lr=3e-3, warmup_steps=2,
                                 steps=8, batch_size=4)
    info = {}
    out = tp.pretrain_beats(wavs, tmp_path / "pre.pt", cfg, pad_to=N, verbose=False,
                            device="cpu", run_info=info)
    losses = info["losses"]
    assert len(losses) == 8 and all(np.isfinite(losses))
    assert np.mean(losses[-3:]) < np.mean(losses[:3]), losses
    assert all(c == round(0.6 * N_TOK) for row in info["masked"] for c in row)
    saved = torch.load(out, weights_only=False)
    assert not any("mask_token" in k for k in saved["model"])

    labels = np.eye(3, dtype=np.float32)[[0, 1, 2, 0, 1, 2]]
    info2 = {}
    out2 = tp.finetune_beats_weak(wavs, labels, tmp_path / "fine.pt", init_params_path=out,
                                  cfg=cfg, pad_to=N, verbose=False, device="cpu",
                                  run_info=info2)
    assert all(np.isfinite(info2["losses"]))
    assert np.mean(info2["losses"][-3:]) < np.mean(info2["losses"][:3]), info2["losses"]
    for path in (out, out2):
        model = build_embedder("beats", path, device="cpu")
        assert model.cfg == tb.BEATsConfig(**TINY)
        with torch.no_grad():
            emb = model(torch.zeros(2, N))
        assert emb["frame"].shape == (2, 32, N_TOK) and torch.isfinite(emb["frame"]).all()
