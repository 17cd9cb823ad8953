"""Rank functions of the port's multi-rank CPU tests (test_torch_parallel_*,
test_torch_sharded_*, test_torch_tp_beats), run by
desed_task_tpu_torch.parallel.launch.spawn_ranks on gloo ranks.

This module imports no jax: each rank is a new process that imports it by
name. Every rank computes on one thread, so that a rank's arithmetic is the
same as another's and the tests stay small beside pytest's workers.
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.distributed as dist

from desed_task_tpu_torch.parallel import (
    all_reduce_mean, make_mesh, rank_seed, replicate, shard_batch)


def _one_thread():
    torch.set_num_threads(1)


def _state_dicts(state):
    return ({k: v.clone() for k, v in state.student.state_dict().items()},
            {k: v.clone() for k, v in state.teacher.state_dict().items()},
            [t.clone() for t in state.opt_state["mu"] + state.opt_state["nu"]])


def mesh_rank(rank, world, batch):
    """The mesh's groups, shard_batch on batch axes 0 and 1, replicate and
    all_reduce_mean on a (data=2, model=2) mesh."""
    _one_thread()
    mesh = make_mesh({"data": 2, "model": 2})
    t = torch.full((3,), float(rank))
    replicate(t, mesh)
    (mean,) = all_reduce_mean([torch.tensor([float(rank), 2.0 * rank])], mesh.groups["data"])
    return dict(
        shape=mesh.shape, index=mesh.index, size=mesh.size,
        data_ranks=dist.get_process_group_ranks(mesh.groups["data"]),
        model_ranks=dist.get_process_group_ranks(mesh.groups["model"]),
        cpu_data_ranks=dist.get_process_group_ranks(mesh.cpu_groups["data"]),
        shards={ax: shard_batch(batch, mesh, batch_axis=ax) for ax in (0, 1)},
        tensor_shard=shard_batch({"x": torch.arange(8.0).reshape(4, 2)}, mesh)["x"],
        replicated=t, data_mean=mean)


def failing_rank(rank, world):
    if rank == 1:
        raise ValueError("rank 1 fails on purpose")
    dist.barrier()  # rank 0 waits on the rank that failed


def sleeping_rank(rank, world):
    time.sleep(90 if rank == 1 else 0)


def skipped_collective_rank(rank, world):
    """Rank 0 all-reduces over the mesh's data group, rank 1 never does."""
    mesh = make_mesh({"data": world})
    if rank == 0:
        dist.all_reduce(torch.ones(4), group=mesh.groups["data"])
    else:
        time.sleep(30)


def _build_model(spec):
    from desed_task_tpu_torch.models.crnn import CRNN

    model = CRNN(n_mels=spec["n_mels"], **spec["net"])
    model.load_state_dict(spec["init"], strict=True)
    return model


def _mt_config(spec):
    from desed_task_tpu_torch.training import MeanTeacherConfig, SlotSpec

    cfg = dict(spec["cfg"])
    cfg["slots"] = tuple(SlotSpec(*s) for s in cfg["slots"])
    return MeanTeacherConfig(**cfg)


def sharded_step_rank(rank, world, spec):
    """`spec["steps"]` steps of make_train_step_sharded over {"data": world}
    on the rank's shard of spec["batch"]; each step's metrics, gradients (the
    rank mean), student, teacher and Adam moments."""
    from desed_task_tpu_torch.ops.frontend import MelConfig
    from desed_task_tpu_torch.training import create_state, make_optimizer
    from desed_task_tpu_torch.training import make_train_step_sharded

    _one_thread()
    mesh = make_mesh({"data": world})
    cfg = _mt_config(spec)
    opt, sched = make_optimizer(spec["lr"], spec["rampup"])
    state = create_state(_build_model(spec), cfg, opt, device="cpu")
    replicate([state.student, state.teacher], mesh)
    acc = spec.get("accumulate", 1)
    step = make_train_step_sharded(cfg, opt, sched, mesh, spec["batch"],
                                   mel_cfg=MelConfig(n_mels=spec["n_mels"]), accumulate=acc)
    shard = shard_batch(spec["batch"], mesh, batch_axis=0 if acc == 1 else 1)
    gen = torch.Generator().manual_seed(rank_seed(1, rank, world))
    runs = []
    for _ in range(spec["steps"]):
        metrics = step(state, shard, gen)
        student, teacher, moments = _state_dicts(state)
        runs.append(dict(metrics={k: float(v) for k, v in metrics.items()},
                         grads={n: p.grad.clone() for n, p in state.student.named_parameters()},
                         student=student, teacher=teacher, moments=moments))
    return runs


def world_one_rank(rank, world, spec):
    """make_train_step_sharded on {"data": 1} against make_train_step from
    the same state, batch and generator seed: each step's metrics, gradients,
    student, teacher and Adam moments, bitwise."""
    from desed_task_tpu_torch.ops.frontend import MelConfig
    from desed_task_tpu_torch.training import (create_state, make_optimizer, make_train_step,
                                               make_train_step_sharded)

    _one_thread()
    mesh = make_mesh({"data": 1})
    cfg = _mt_config(spec)
    mel = MelConfig(n_mels=spec["n_mels"])
    out = []
    for sharded in (False, True):
        opt, sched = make_optimizer(spec["lr"], spec["rampup"])
        state = create_state(_build_model(spec), cfg, opt, device="cpu")
        step = (make_train_step_sharded(cfg, opt, sched, mesh, spec["batch"], mel_cfg=mel)
                if sharded else make_train_step(cfg, opt, sched, mel_cfg=mel))
        gen = torch.Generator().manual_seed(7)
        runs = []
        for _ in range(spec["steps"]):
            metrics = step(state, spec["batch"], gen)
            runs.append(({k: v.clone() if torch.is_tensor(v) else v for k, v in metrics.items()},
                         [p.grad.clone() for p in state.student.parameters()],
                         *_state_dicts(state)))
        out.append(runs)
    return out


def sharded_eval_rank(rank, world, spec):
    """The eval cache's scan on the rank's row block, gathered to rank 0 (and,
    on rank 0, the single-device cache's scan of the same items)."""
    from desed_task_tpu_torch.data.device_cache import DeviceEvalCache
    from desed_task_tpu_torch.labels.encoder import ManyHotEncoder
    from desed_task_tpu_torch.ops.frontend import MelConfig
    from desed_task_tpu_torch.training import make_predict_step
    from desed_task_tpu_torch.training.evaluate import _predict_cache_all, predict_dataset

    _one_thread()
    mesh = make_mesh({"data": world})
    model = _build_model(spec).eval()
    predict = make_predict_step(MelConfig(**spec["mel"]))
    bs, med = spec["batch_size"], spec["median"]
    out = {}
    if rank == 0:
        single = DeviceEvalCache(spec["items"], bs, device="cpu")
        single.upload()
        out["single"] = _predict_cache_all(predict, model, single, None, med, want_raw=True)
    cache = DeviceEvalCache(spec["items"], bs, n_shards=world, device="cpu")
    cache.upload(mesh=mesh)
    out["rows"] = cache.rows
    out["sharded"] = _predict_cache_all(predict, model, cache, None, med, want_raw=True)
    enc = ManyHotEncoder(*spec["encoder"])
    got = predict_dataset(predict, model, cache, enc, bs, thresholds=(0.5,), median_filter=med)
    out["decoded"] = None if got is None else (sorted(got[0]), got[3])
    return out


def tp_beats_rank(rank, world, spec):
    """On a (data=1, model=2) mesh: the full BEATs and the tensor-parallel
    one on the same audio, then the e2e step with the tensor-parallel BEATs
    in it (make_train_step_sharded), each step's metrics, gradients and
    states."""
    from desed_task_tpu_torch.models.beats import BEATsConfig, BEATsModel
    from desed_task_tpu_torch.ops.frontend import MelConfig
    from desed_task_tpu_torch.parallel.tp import shard_beats
    from desed_task_tpu_torch.tools.embeddings import frame_embedder
    from desed_task_tpu_torch.training import create_state, make_optimizer
    from desed_task_tpu_torch.training import make_train_step_sharded

    _one_thread()
    mesh = make_mesh({"data": 1, "model": 2})
    full = BEATsModel(BEATsConfig(**spec["beats_cfg"]))
    full.load_state_dict(spec["beats"], strict=True)
    tp = shard_beats(full, mesh)
    audio = torch.as_tensor(spec["audio"])
    with torch.no_grad():
        ref, got = full(audio)["frame"], tp(audio)["frame"]
    before = {k: v.clone() for k, v in tp.state_dict().items()}
    cfg = _mt_config(spec)
    opt, sched = make_optimizer(spec["lr"], spec["rampup"])
    state = create_state(_build_model(spec), cfg, opt, device="cpu")
    step = make_train_step_sharded(cfg, opt, sched, mesh, spec["batch"],
                                   mel_cfg=MelConfig(n_mels=spec["n_mels"]),
                                   embedder=frame_embedder(tp))
    gen = torch.Generator().manual_seed(1)
    runs = []
    for _ in range(spec["steps"]):
        metrics = step(state, shard_batch(spec["batch"], mesh), gen)
        student, teacher, _ = _state_dicts(state)
        runs.append(dict(metrics={k: float(v) for k, v in metrics.items()},
                         grads={n: p.grad.clone() for n, p in state.student.named_parameters()},
                         student=student, teacher=teacher))
    unchanged = all(torch.equal(v, before[k]) for k, v in tp.state_dict().items())
    heads = tp.encoder.encoder.layers[0].self_attn.heads
    return dict(full=ref, tp=got, runs=runs, beats_unchanged=unchanged, local_heads=heads,
                grad_free=all(p.grad is None and not p.requires_grad for p in tp.parameters()))


def recipe_rank(rank, world, config, log_dir, resume=False):
    """single_run (fast_dev_run, fp32, on the CPU) on every rank, into one
    log directory; with `resume`, a second run resumes from its last
    checkpoint (its 2 epochs are done: the loop restores and trains none)."""
    from desed_task_tpu_torch.training.single_run import single_run

    _one_thread()
    out = []
    for again in ((False, True) if resume else (False,)):
        info = {}
        state, results = single_run(config, log_dir, fast_dev_run=True, fast=False,
                                    device="cpu", checkpoint_resume=again, run_info=info)
        loop = info["loop"]
        student, teacher, moments = _state_dicts(state)
        out.append(dict(
            step=state.step, student=student, teacher=teacher, moments=moments,
            results=None if results is None else {k: v for k, v in results.items()
                                                  if isinstance(v, float)},
            mesh_shape=info["mesh"].shape, epochs=[h["epoch"] for h in loop.history],
            generator=loop.rng.get_state(), start_epoch=loop.start_epoch,
            logs=loop.logger is not None,
            n_devices=None if loop.energy is None else loop.energy.n_devices))
    return out


def unsharded_test_rank(rank, world, config, log_dir):
    """single_run (fast_dev_run, fp32, on the CPU) with the eval sets left on
    the host (device_cache_eval: false), so that every rank scores the whole
    test set; what each rank handed run_test as save_dir, and its result."""
    import desed_task_tpu_torch.training.single_run as sr

    _one_thread()
    save_dirs = []
    run_test = sr.run_test

    def spy(*args, **kw):
        save_dirs.append(kw.get("save_dir"))
        return run_test(*args, **kw)

    sr.run_test = spy
    _, results = sr.single_run(config, log_dir, fast_dev_run=True, fast=False, device="cpu")
    return dict(save_dirs=[None if d is None else str(d) for d in save_dirs],
                results=None if results is None else {k: v for k, v in results.items()
                                                      if isinstance(v, float)})


def save_resume_rank(rank, world, log_dir):
    """TrainLoop on a {"data": 2, "model": 2} mesh: every rank saves the
    "last" checkpoint (rank 0 writes it), draws on, then resumes from it
    with a fresh generator; the generator state each rank saved and got
    back, and how many rank states the checkpoint holds."""
    import types

    from desed_task_tpu_torch.obs.checkpoint import CheckpointManager
    from desed_task_tpu_torch.training.loop import TrainLoop

    _one_thread()
    mesh = make_mesh({"data": 2, "model": 2})
    torch.manual_seed(0)
    net = torch.nn.Linear(3, 2)
    state = types.SimpleNamespace(step=3, student=net, teacher=torch.nn.Linear(3, 2),
                                  opt_state={"count": 3, "mu": [], "nu": []}, scaler=None)
    ckpt = CheckpointManager(log_dir)
    gen = torch.Generator().manual_seed(1000 + rank)
    torch.rand(5 + rank, generator=gen)
    loop = TrainLoop(None, state, None, 1, None, ckpt=ckpt, rng=gen, mesh=mesh)
    saved = gen.get_state()
    loop._save("last", {"epoch": 0, "best_obj": 0.5})
    torch.rand(7, generator=gen)
    again = TrainLoop(None, state, None, 1, None, ckpt=ckpt,
                      rng=torch.Generator().manual_seed(7), mesh=mesh)
    resumed = again.resume("last")
    return dict(saved=saved, restored=again.rng.get_state(), resumed=resumed,
                start_epoch=again.start_epoch, index=mesh.index,
                n_states=len(ckpt.load("last")["rank_generators"]))
