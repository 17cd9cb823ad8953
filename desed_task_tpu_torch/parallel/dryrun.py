"""One data- and tensor-parallel train step on n ranks, end to end
(counterpart of the JAX package's __graft_entry__.dryrun_multichip).

    python -c "from desed_task_tpu_torch.parallel.dryrun import dryrun_multichip; \
               dryrun_multichip(4)"

spawns n ranks (parallel/launch.spawn_ranks: a rendezvous file, gloo on
the CPU) and runs, on each:
  1. the e2e mean-teacher step with a tiny BEATs in the step, tensor-
     parallel over a (data = n / 2, model = 2) mesh (model = 1 for odd n):
     __graft_entry__'s tiny BEATs config and slots [1, 1, 1, 1, 2] a data
     shard, one second of audio;
  2. make_train_step_sharded over (data = n) at the flagship shapes: ten
     seconds of audio, T = 156, 27 classes, 768 x 496 float16 embeddings,
     slots [2, 1, 1, 2, 4] a rank;
  3. the sharded eval: 2 n + 3 clips (not a whole number of shards) in a
     DeviceEvalCache row-sharded over the data axis, gathered to rank 0.
Each rank's losses must be finite and its state one step on; the ok lines
are printed from rank 0's results. device="cuda" puts rank r on card
r mod the card count (NCCL by default; pass backend="gloo" when ranks share
a card).
"""

from __future__ import annotations

import os

import numpy as np

TINY_BEATS = dict(encoder_layers=2, encoder_embed_dim=64, embed_dim=32,
                  encoder_ffn_embed_dim=128, encoder_attention_heads=4, conv_pos=16,
                  conv_pos_groups=4, num_buckets=32, max_distance=64)
SLOTS = (("maestro", "strong"), ("synth", "strong"), ("strong", "strong"), ("weak", "weak"),
         ("unlabeled", "unlabeled"))
N_CLASS = 27


def _config(sizes):
    from ..training import MeanTeacherConfig, SlotSpec

    return MeanTeacherConfig(
        slots=tuple(SlotSpec(name, size, role) for (name, role), size in zip(SLOTS, sizes)),
        mixup="soft", mixup_prob=0.5,
        mixup_groups=(("weak",), ("synth", "strong"), ("maestro",)),
        consistency_start_slot=1, rampup_steps=100, decay_steps=200)


def _batch(rng, cfg, n_samples, emb=None):
    t_lab = n_samples // 256 // 4
    batch = {}
    for s in cfg.slots:
        batch[s.name] = {
            "audio": rng.standard_normal((s.size, n_samples)).astype(np.float32) * 0.05,
            "labels": (rng.random((s.size, N_CLASS, t_lab)) > 0.9).astype(np.float32),
            "class_mask": np.ones((s.size, N_CLASS), bool),
        }
        if emb is not None:
            batch[s.name]["embeddings"] = rng.standard_normal((s.size, *emb)).astype(np.float16)
    return batch


def _step(mesh, cfg, model, batch, device, seed, embedder=None):
    """One make_train_step_sharded step on this rank's shard: (loss, step)."""
    import torch

    from ..parallel import rank_seed, replicate, shard_batch
    from ..training import create_state, make_optimizer, make_train_step_sharded

    tx, sched = make_optimizer(lr=1e-3, rampup_steps=100)
    state = create_state(model, cfg, tx, device=device)
    replicate([state.student, state.teacher], mesh)
    step = make_train_step_sharded(cfg, tx, sched, mesh, batch, embedder=embedder)
    gen = torch.Generator(device=device).manual_seed(
        rank_seed(seed, mesh.index["data"], mesh.shape["data"]))
    metrics = step(state, shard_batch(batch, mesh), gen)
    return float(metrics["loss"]), state.step, state


def _rank(rank, world, device):
    import torch

    from ..labels.encoder import ManyHotEncoder
    from ..models.beats import BEATsConfig, BEATsModel, init_beats
    from ..parallel import make_mesh
    from ..parallel.tp import shard_beats
    from ..recipes_config import crnn_2024
    from ..tools.embeddings import frame_embedder
    from ..training import make_predict_step
    from ..training.evaluate import predict_dataset
    from ..utils import table as tbl

    if device == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    else:
        device = f"cuda:{rank % torch.cuda.device_count()}"
        torch.cuda.set_device(device)
    out = {}

    # 1: the e2e step, tiny BEATs tensor-parallel over 'model'
    model_par = 2 if world % 2 == 0 else 1
    data_par = world // model_par
    mesh = make_mesh({"data": data_par, "model": model_par})
    n_samples = 16000
    beats = init_beats(BEATsModel(BEATsConfig(**TINY_BEATS)), torch.Generator().manual_seed(5))
    tp = shard_beats(beats.to(device), mesh)
    torch.manual_seed(0)
    cfg = _config([1 * data_par, 1 * data_par, 1 * data_par, 1 * data_par, 2 * data_par])
    model = crnn_2024(nclass=N_CLASS, embedding_size=TINY_BEATS["encoder_embed_dim"])
    batch = _batch(np.random.default_rng(0), cfg, n_samples)
    out["e2e"] = _step(mesh, cfg, model, batch, device, seed=1, embedder=frame_embedder(tp))[:2]
    out["mesh"] = (data_par, model_par)

    # 2: the deployed data-parallel step at the flagship shapes
    dmesh = make_mesh({"data": world})
    cfg2 = _config([2 * world, 1 * world, 1 * world, 2 * world, 4 * world])
    torch.manual_seed(2)
    batch2 = _batch(np.random.default_rng(1), cfg2, 160000, emb=(768, 496))
    loss, step, state2 = _step(dmesh, cfg2, crnn_2024(nclass=N_CLASS, embedding_size=768),
                               batch2, device, seed=3)
    out["flagship"] = (loss, step, cfg2.batch_size)

    # 3: the sharded eval, gathered to rank 0
    from ..data.device_cache import DeviceEvalCache

    rng = np.random.default_rng(2)
    n_eval = 2 * world + 3
    items = [{"audio": rng.standard_normal(160000).astype(np.float32) * 0.05,
              "labels": (rng.random((N_CLASS, 156)) > 0.9).astype(np.float32),
              "embeddings": rng.standard_normal((768, 496)).astype(np.float16),
              "filename": f"eval_{i}.wav"} for i in range(n_eval)]
    enc = ManyHotEncoder([f"c{i}" for i in range(N_CLASS)], audio_len=10.0, frame_len=2048,
                         frame_hop=256, net_pooling=4, fs=16000)
    cache = DeviceEvalCache(items, batch_size=2, n_shards=world, device=device)
    cache.upload(mesh=dmesh)
    got = predict_dataset(make_predict_step(), state2.student, cache, enc, batch_size=2,
                          thresholds=(0.5,), median_filter=[3] * N_CLASS)
    if got is not None:
        out["eval"] = (got[3].shape, bool(np.isfinite(got[3]).all()), tbl.n_rows(got[2][0.5]))
    return out


def dryrun_multichip(n: int, device: str = "cpu", backend: str | None = None,
                     timeout_s: float = 600.0) -> list:
    """Run the three phases on n spawned ranks; raises unless every rank's
    losses are finite and its step is 1. Returns each rank's results."""
    from ..device import resolve_device
    from .launch import spawn_ranks

    resolve_device(device)  # no card: raise here, not in every rank
    if backend is None:
        backend = "gloo" if device == "cpu" else "nccl"
    results = spawn_ranks(_rank, n, args=(device,), backend=backend, timeout_s=timeout_s)
    for r, res in enumerate(results):
        for phase in ("e2e", "flagship"):
            loss, step = res[phase][:2]
            if not np.isfinite(loss) or step != 1:
                raise RuntimeError(f"rank {r}, {phase}: loss {loss}, step {step}")
    shape, finite, events = results[0]["eval"]
    if shape != (2 * n + 3, N_CLASS) or not finite:
        raise RuntimeError(f"sharded eval: weak scores {shape}, finite {finite}")
    d, m = results[0]["mesh"]
    print(f"dryrun_multichip({n}): ok on mesh (data={d}, model={m}), e2e BEATs TP, "
          f"losses {[r['e2e'][0] for r in results]}, step 1 on every rank", flush=True)
    print(f"dryrun_multichip({n}): ok make_train_step_sharded on (data={n}) at flagship "
          f"shapes (10 s audio, T=156, emb 768x496, {results[0]['flagship'][2]} clips/step), "
          f"losses {[r['flagship'][0] for r in results]}", flush=True)
    print(f"dryrun_multichip({n}): ok sharded eval on (data={n}): {2 * n + 3} clips "
          f"row-sharded, scores gathered to rank 0 ({events} events decoded)", flush=True)
    return results
