"""The port's run records (obs/) against the JAX package: checkpoints (round
trip into a state in place, best tracking, the generator's state),
metrics.csv and hparams.json byte for byte against JAX's logger, the energy
model against JAX's formula given the same watts and its refusal to guess
the card's watts, the analytic MACs against XLA's cost analysis of the same
CRNN, and the reference state_dict loader against JAX's converter."""

import json
import stat

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from desed_task_tpu.models.torch_convert import convert_crnn_state_dict as jax_convert
from desed_task_tpu.obs import energy as jenergy
from desed_task_tpu.obs import logging as jlogging
from desed_task_tpu.obs.macs import compiled_flops
from desed_task_tpu.recipes_config import crnn_2024 as jax_crnn_2024
from desed_task_tpu_torch.models.convert import (
    convert_crnn_state_dict, convert_gru_state_dict, from_jax_params)
from desed_task_tpu_torch.models.crnn import CRNN
from desed_task_tpu_torch.models.rnn import BidirectionalGRU
from desed_task_tpu_torch.obs import energy as tenergy
from desed_task_tpu_torch.obs import logging as tlogging
from desed_task_tpu_torch.obs.checkpoint import CheckpointManager
from desed_task_tpu_torch.obs.macs import forward_macs, macs_report
from desed_task_tpu_torch.recipes_config import crnn_2024
from desed_task_tpu_torch.training import MeanTeacherConfig, SlotSpec, create_state
from desed_task_tpu_torch.training import make_optimizer

NET = dict(nclass=3, n_RNN_cell=4, n_layers_RNN=1, kernel_size=[3, 3], padding=[1, 1],
           stride=[1, 1], nb_filters=[4, 8], pooling=[[2, 2], [2, 2]], n_mels=16)
CFG = MeanTeacherConfig(slots=(SlotSpec("a", 2, "strong"),))


def _state(seed):
    torch.manual_seed(seed)
    opt, _ = make_optimizer(1e-3, 10)
    st = create_state(CRNN(**NET), CFG, opt, device="cpu")
    g = torch.Generator().manual_seed(seed)
    for t in (*st.student.state_dict().values(), *st.teacher.state_dict().values(),
              *st.opt_state["mu"], *st.opt_state["nu"]):
        t.copy_(torch.randn(t.shape, generator=g))
    st.step, st.opt_state["count"] = 7 + seed, 7 + seed
    return st


def _equal_states(a, b):
    for who in ("student", "teacher"):
        x, y = getattr(a, who).state_dict(), getattr(b, who).state_dict()
        assert x.keys() == y.keys()
        for k in x:
            assert torch.equal(x[k], y[k]), (who, k)
    for k in ("mu", "nu"):
        assert all(torch.equal(x, y) for x, y in zip(a.opt_state[k], b.opt_state[k]))
    assert a.opt_state["count"] == b.opt_state["count"] and a.step == b.step


def test_checkpoint_roundtrip_in_place(tmp_path):
    st, fresh = _state(0), _state(1)
    gen = torch.Generator().manual_seed(123)
    torch.rand(5, generator=gen)  # a generator part way along its stream
    mgr = CheckpointManager(tmp_path / "ckpt")
    mgr.save(st, {"epoch": 1}, generator=gen)
    assert mgr.exists("last") and not mgr.exists("best")
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == ["last", "last.meta.json"]
    g2 = torch.Generator().manual_seed(5)
    out = mgr.restore("last", fresh, generator=g2)
    assert out is fresh
    _equal_states(st, fresh)
    assert torch.equal(g2.get_state(), gen.get_state())
    assert g2.initial_seed() == 123
    assert torch.equal(torch.rand(3, generator=g2), torch.rand(3, generator=gen))
    assert mgr.metadata("last") == {"epoch": 1}
    # a checkpoint without the generator's state cannot restore one
    mgr.save(st, name="nogen")
    with pytest.raises(ValueError, match="generator"):
        mgr.restore("nogen", _state(2), generator=torch.Generator())


def test_checkpoint_best_tracking(tmp_path):
    mgr = CheckpointManager(tmp_path / "ckpt")
    a, b = _state(0), _state(1)
    assert mgr.save_if_best(a, 0.5)
    assert not mgr.save_if_best(b, 0.4)
    assert mgr.save_if_best(b, 0.9, {"epoch": 3})
    assert json.loads((tmp_path / "ckpt" / "manager.json").read_text()) == {
        "scores": {"best": 0.9}}
    got = mgr.restore("best", _state(2))
    _equal_states(b, got)
    assert mgr.metadata("best") == {"epoch": 3, "score": 0.9}
    # a new manager on the same directory keeps the best score
    assert not CheckpointManager(tmp_path / "ckpt").save_if_best(a, 0.8)


def test_checkpoint_loads_weights_only(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(_state(0), generator=torch.Generator())
    payload = torch.load(tmp_path / "last", weights_only=True)
    assert set(payload) == {"step", "student", "teacher", "opt_state", "scaler", "generator"}


@pytest.mark.parametrize("use_tb", [False, True])
def test_metrics_csv_and_hparams_bytes_match_jax(tmp_path, monkeypatch, use_tb):
    monkeypatch.setattr(jlogging.time, "time", lambda: 1700000000.1234)
    monkeypatch.setattr(tlogging.time, "time", lambda: 1700000000.1234)
    hp = {"training": {"batch_size": [1, 2], "lr": 1e-3, "mixup": None},
          "net": {"nclass": 27, "attention": True}, "path": tmp_path}
    scalars = [(0, {"a/b": 1.5, "c": np.float32(0.25), "skip": "text", "n": 3}),
               (7, {"val/obj_metric": float("nan"), "t": torch.tensor(2.0)})]
    for mod, d in ((jlogging, "jax"), (tlogging, "port")):
        lg = mod.MetricsLogger(tmp_path / d, use_tensorboard=use_tb)
        lg.log_hparams(hp)
        for step, s in scalars:
            lg.log_scalars(step, {k: (float(v) if d == "jax" and isinstance(v, torch.Tensor)
                                      else v) for k, v in s.items()})
        lg.close()
    for name in ("metrics.csv", "hparams.json"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    if use_tb:
        assert any(p.name.startswith("events.out") for p in (tmp_path / "port").iterdir())


def test_energy_matches_jax_formula(monkeypatch, tmp_path):
    for mod in (jenergy, tenergy):
        monkeypatch.setattr(mod.time, "monotonic", lambda: 0.0)
    kw = dict(device_watts=300.0, host_watts=80.0, idle_fraction=0.2,
              device_watts_range=(250.0, 350.0))
    j = jenergy.EnergyTracker("train", out_dir=tmp_path / "j", **kw)
    t = tenergy.EnergyTracker("train", out_dir=tmp_path / "t", device="cpu", **kw)
    for trk in (j, t):
        trk.start()
        trk.record_busy(42.5)
    for mod in (jenergy, tenergy):
        monkeypatch.setattr(mod.time, "monotonic", lambda: 3600.0)
    assert t.energy_kwh == j.energy_kwh
    assert t.energy_kwh_range == j.energy_kwh_range
    assert t.stop() == j.stop()
    rep_t = json.loads((tmp_path / "t" / "energy_train.json").read_text())
    rep_j = json.loads((tmp_path / "j" / "energy_train.json").read_text())
    for k in ("elapsed_s", "busy_s", "estimated_kwh", "estimated_kwh_range", "device_watts"):
        assert rep_t[k] == rep_j[k], k
    assert rep_t["card"] is None and "v5e" not in rep_t["note"]


def _fake_nvidia_smi(tmp_path, text):
    exe = tmp_path / "nvidia-smi"
    exe.write_text(f"#!/bin/sh\necho '{text}'\n")
    exe.chmod(exe.stat().st_mode | stat.S_IEXEC)
    return str(tmp_path)


def test_energy_reads_the_cards_power_limit(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", _fake_nvidia_smi(tmp_path, "NVIDIA H100 80GB HBM3, 700.00 W"))
    trk = tenergy.EnergyTracker("train", out_dir=tmp_path, device="cuda").start()
    assert trk.card == "NVIDIA H100 80GB HBM3" and trk.power_limit_w == 700.0
    assert trk.device_watts == 700.0 and trk.device_watts_range == (700.0, 700.0)
    trk.stop()
    rep = json.loads((tmp_path / "energy_train.json").read_text())
    assert rep["card"] == "NVIDIA H100 80GB HBM3" and rep["power_limit_w"] == 700.0


@pytest.mark.parametrize("smi", [None, "garbled"])
def test_energy_refuses_to_guess_on_the_card(monkeypatch, tmp_path, smi):
    path = str(tmp_path) if smi is None else _fake_nvidia_smi(tmp_path, smi)
    monkeypatch.setenv("PATH", path)
    trk = tenergy.EnergyTracker("train", device="cuda")
    with pytest.raises(RuntimeError, match="power limit"):
        trk.start()
    with pytest.raises(ValueError, match="device_watts"):
        tenergy.EnergyTracker("train", device="cpu")


def test_macs_close_to_xla_cost_analysis():
    """The 2024 CRNN on 10 s: the port's analytic count within 15 % of XLA's
    cost analysis of the JAX CRNN's compiled forward (the bound JAX's own
    count is held to against the published THOP figure). The gap found:
    the analytic count is 0.1-1 % below XLA's (XLA also counts the
    elementwise work, the softmax and the GRU gates)."""
    model_j = jax_crnn_2024(fused_blocks=False, rnn_pallas=False)
    x = jnp.zeros((1, 128, 626), jnp.float32)
    emb = jnp.zeros((1, 768, 496), jnp.float32)
    v = model_j.init({"params": jax.random.key(0)}, x, embeddings=emb, train=False)
    xla = compiled_flops(lambda x, e: model_j.apply(v, x, embeddings=e, train=False), x, emb)
    ours = forward_macs(crnn_2024(), 626, 128, 496)
    gap = ours["macs"] / xla["macs"] - 1
    print(f"analytic {ours['macs'] / 1e6:.3f} MMACs, XLA {xla['macs'] / 1e6:.3f}: {gap:+.4f}")
    assert abs(gap) <= 0.15, gap
    assert ours["flops"] == 2 * ours["macs"]
    assert "MMACs" in macs_report(crnn_2024(), 626, 128, 496)


def _reference_state_dict(net, seed=0):
    """A random state dict with the reference DESED_task CRNN's key names."""
    g = torch.Generator().manual_seed(seed)
    port = CRNN(**net).state_dict()
    ref = {}
    for k, v in port.items():
        if k.startswith("cnn."):
            name = "cnn.cnn." + k[4:]
        elif k.startswith("rnn."):
            name = "rnn.rnn." + k[4:]
        elif k.startswith("shrink_emb_dense."):
            name = "shrink_emb.0." + k.split(".", 1)[1]
        elif k.startswith("shrink_emb_ln."):
            name = "shrink_emb.1." + k.split(".", 1)[1]
        elif k.startswith(("dense_", "dense_softmax_")) and k.split(".")[0][-1].isdigit():
            mod, leaf = k.split(".")
            name = f"{mod.rsplit('_', 1)[0]}.{mod.rsplit('_', 1)[1]}.{leaf}"
        else:
            name = k
        ref[name] = torch.randn(v.shape, generator=g)
        if name.endswith("running_var"):
            ref[name] = ref[name].abs() + 0.5
    for i in range(len(net["nb_filters"])):
        ref[f"cnn.cnn.batchnorm{i}.num_batches_tracked"] = torch.tensor(3)
    return ref


@pytest.mark.parametrize("net", [
    dict(NET, use_embeddings=True, embedding_size=6, aggregation_type="pool1d"),
    dict(NET, use_embeddings=True, embedding_size=6, aggregation_type="frame",
         frame_emb_enc_dim=5),
    dict(NET, nclass=[3, 2]),
])
def test_reference_state_dict_loader_matches_jax(net):
    ref = _reference_state_dict(net)
    via_jax = jax_convert(ref)
    want = from_jax_params(via_jax["params"], via_jax.get("batch_stats"))
    got = convert_crnn_state_dict(ref)
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    a, b = CRNN(**net).eval(), CRNN(**net).eval()
    a.load_state_dict(got, strict=True)
    b.load_state_dict(want, strict=True)
    x = torch.randn(2, 16, 20, generator=torch.Generator().manual_seed(1))
    kw = {"embeddings": torch.randn(2, 6, 7)} if net.get("use_embeddings") else {}
    with torch.no_grad():
        for u, w in zip(a(x, **kw), b(x, **kw)):
            assert torch.equal(u, w)
    with pytest.raises(KeyError):  # a CNN module no rule maps
        convert_crnn_state_dict({**ref, "cnn.cnn.instancenorm0.weight": torch.zeros(1)})


def test_gru_state_dict_loader():
    gru = torch.nn.GRU(5, 4, bidirectional=True, batch_first=True)
    sd = {f"rnn.{k}": v for k, v in gru.state_dict().items()}
    got = convert_gru_state_dict(sd, prefix="rnn.")
    port = BidirectionalGRU(5, 4, 1)
    port.load_state_dict(got, strict=True)
    x = torch.randn(2, 9, 5)
    with torch.no_grad():
        torch.testing.assert_close(port(x, train=False), gru(x)[0], rtol=1e-5, atol=1e-6)
