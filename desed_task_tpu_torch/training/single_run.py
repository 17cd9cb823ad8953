"""Config-driven end-to-end run: the engine behind the recipe CLI
(counterpart of desed_task_tpu/training/single_run.py).

Replaces the per-year single_run functions of the reference
(recipes/dcase202X_task4_baseline/train_*.py:157-592): encoder(s),
datasets, the fixed-slot batcher (or the device-resident train store), the
CRNN, optimizer and schedule, validator, train loop, then the test battery
from the best checkpoint. Driven by the reference confs' section layout
(training / data / opt / feats / net / scaler / pretrained).

Slots are inferred from the configured data paths:
  [maestro?] [synth] [strong?] [weak] [unlabeled]
with training.batch_size listing the present slots' sizes in that order
(pretrained.yaml:8).

Runs on one device, "cuda" unless the caller passes another; the tsv files
are read without pandas (utils/table.py).

On several ranks (torchrun --nproc_per_node=N, which sets WORLD_SIZE > 1,
or a process group the caller has joined already), as the JAX single_run
on a mesh (single_run.py:357-369, :458-470): the run joins the group
(parallel.init_distributed), takes cuda:LOCAL_RANK unless the caller names
a device, and trains with make_train_step_sharded over a data mesh of all
ranks. Every rank draws the same global batches from the same seed and
keeps its own rows (parallel.shard_batch), so the host work of reading and
decoding a batch is repeated on each rank; the train store stays off, and
validation and test run from eval caches row-sharded over the ranks. A slot
size that the number of ranks does not divide raises (the JAX run falls
back to one device there). The first rank alone logs, checkpoints, bills
the energy of every card and writes the test's files; a group that the run
joined, it leaves at the end.
"""

from __future__ import annotations

import os
import random
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from ..data.batcher import MultiSourceBatcher
from ..data.datasets import ConcatSet, StronglyAnnotatedSet, UnlabeledSet, WeakSet
from ..device import resolve_device
from ..labels.encoder import CatManyHotEncoder, ManyHotEncoder
from ..models.crnn import CRNN
from ..obs.checkpoint import CheckpointManager
from ..obs.energy import EnergyTracker
from ..obs.logging import MetricsLogger
from ..obs.macs import macs_report
from ..obs.watchdog import StallWatchdog
from ..ops.frontend import MelConfig
from ..ops.scaler import ScalerConfig, fit_scaler
from ..utils import table as tbl
from ..utils.classes_dict import (
    CLASSES_DESED,
    CLASSES_MAESTRO_REAL,
    CLASSES_MAESTRO_REAL_EVAL,
    MAESTRO_DESED_ALIAS,
    process_tsvs,
)
from .evaluate import SEDValidator, run_test
from .loop import TrainLoop
from .mean_teacher import (
    MeanTeacherConfig,
    SlotSpec,
    create_state,
    make_optimizer,
    make_predict_step,
    make_train_step,
    make_train_step_sharded,
)


def seed_everything(seed: int):
    """Seeds Python's, numpy's and torch's global generators (model weights
    are drawn from torch's)."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def build_encoder(config: dict) -> ManyHotEncoder:
    data = config["data"]
    feats = config["feats"]
    kw = dict(audio_len=data["audio_max_len"], frame_len=feats["n_filters"],
              frame_hop=feats["hop_length"], net_pooling=data["net_subsample"], fs=data["fs"])
    desed = ManyHotEncoder(list(CLASSES_DESED.keys()), **kw)
    if "real_maestro_train_tsv" in data:
        return CatManyHotEncoder((desed, ManyHotEncoder(list(CLASSES_MAESTRO_REAL.keys()),
                                                        **kw)))
    return desed


MAESTRO_SCENES = (
    "cafe_restaurant",
    "city_center",
    "grocery_store",
    "metro_station",
    "residential_area",
)


def split_maestro(config: dict, maestro_dev) -> tuple[dict, dict]:
    """Seeded per-scene file-level split of the MAESTRO dev windows
    (train_pretrained.py:97-154): window filenames are
    {scene}_{idx}-{onset}-{offset}.wav and the split is over file ids, the
    first maestro_split of each scene's shuffled ids to train. Returns
    (train, valid) column tables, the rows scene by scene in table order."""
    rng = np.random.RandomState(config["training"].get("seed", 42))
    split_f = config["training"].get("maestro_split", 0.9)
    t = tbl.as_columns(maestro_dev)
    file_ids = [x.split("-")[0] for x in t["filename"]]
    scenes = ["_".join(x.split("_")[:-1]) for x in file_ids]
    train_rows, valid_rows = [], []
    for scene_name in MAESTRO_SCENES:
        ids = list(dict.fromkeys(f for f, s in zip(file_ids, scenes) if s == scene_name))
        filenames = np.asarray(ids, dtype=object)
        rng.shuffle(filenames)
        pivot = int(split_f * len(filenames))
        train_ids, valid_ids = set(filenames[:pivot]), set(filenames[pivot:])
        train_rows += [i for i, f in enumerate(file_ids) if f in train_ids]
        valid_rows += [i for i, f in enumerate(file_ids) if f in valid_ids]
    return tbl.take(t, train_rows), tbl.take(t, valid_rows)


def mel_config(config: dict, fast: bool = False) -> MelConfig:
    f = config["feats"]
    return MelConfig(sample_rate=f["sample_rate"], n_fft=f["n_window"], win_length=f["n_window"],
                     hop_length=f["hop_length"], f_min=f["f_min"], f_max=f["f_max"],
                     n_mels=f["n_mels"], compute_dtype="bfloat16" if fast else "float32")


def scaler_config(config: dict) -> ScalerConfig:
    s = config.get("scaler", {})
    return ScalerConfig(statistic=s.get("statistic", "instance"),
                        normtype=s.get("normtype", "minmax"), dims=tuple(s.get("dims", (1, 2))))


def build_model(config: dict, fast: bool = False) -> CRNN:
    """The CRNN of config["net"] for config["feats"]["n_mels"] mels; fast:
    its conv blocks in bf16."""
    net = dict(config["net"])
    net.pop("median_filter", None)
    if fast:
        net["compute_dtype"] = torch.bfloat16
    return CRNN(n_mels=config["feats"]["n_mels"], **net)


def _emb_file(config, split_name):
    pre = config.get("pretrained") or {}
    d = pre.get("extracted_embeddings_dir")
    if not d:
        return None
    path = Path(d) / pre.get("model", "beats") / f"{split_name}.hdf5"
    return str(path) if path.exists() else None


def build_train_datasets(config: dict, encoder, strong_real: bool = False
                         ) -> tuple[dict, dict, list[SlotSpec]]:
    """Returns (datasets, batch_sizes, slot specs) of the present slots.

    The strong (AudioSet real) data joins in one of two ways: as a slot of
    its own when training.batch_size has an entry for it (the 2024
    convention, pretrained.yaml:8), or concatenated into the synth slot
    when `strong_real` is set and the batch list has no strong entry (the
    reference's --strong_real, dcase2022_task4_baseline/train_sed.py:
    163-167). With neither, configured strong paths are ignored.
    """
    data = config["data"]
    emb_type = (config.get("net") or {}).get("embedding_type")
    common = dict(pad_to=data["audio_max_len"], fs=data["fs"], embedding_type=emb_type)
    desed_classes = list(CLASSES_DESED.keys())
    desed_mask = desed_classes if len(encoder.labels) > 10 else None
    datasets: dict = {}
    roles: list[tuple[str, str]] = []

    maestro_val_tsv = None
    if "real_maestro_train_folder" in data:
        tsv, maestro_val_tsv = split_maestro(config, tbl.read_tsv(data["real_maestro_train_tsv"]))
        tsv = process_tsvs(tsv, MAESTRO_DESED_ALIAS)
        valid = list(CLASSES_MAESTRO_REAL.keys()) + list(set(MAESTRO_DESED_ALIAS.values()))
        datasets["maestro"] = StronglyAnnotatedSet(
            data["real_maestro_train_folder"], tsv, encoder,
            embeddings_hdf5_file=_emb_file(config, "maestro_real_train"),
            mask_events_other_than=valid, **common)
        roles.append(("maestro", "strong"))

    datasets["synth"] = StronglyAnnotatedSet(
        data["synth_folder"], tbl.read_tsv(data["synth_tsv"]), encoder,
        embeddings_hdf5_file=_emb_file(config, "synth_train"),
        mask_events_other_than=desed_mask, **common)
    roles.append(("synth", "strong"))

    if "strong_tsv" in data and data.get("strong_folder"):
        # slots without the strong one: [maestro?] synth weak unlabeled
        separate_slot = len(config["training"]["batch_size"]) == len(roles) + 3
        if separate_slot or strong_real:
            strong_set = StronglyAnnotatedSet(
                data["strong_folder"], tbl.read_tsv(data["strong_tsv"]), encoder,
                embeddings_hdf5_file=_emb_file(config, "strong_train"),
                mask_events_other_than=desed_mask, **common)
            if separate_slot:
                datasets["strong"] = strong_set
                roles.append(("strong", "strong"))
            else:
                datasets["synth"] = ConcatSet([strong_set, datasets["synth"]])

    weak_tsv = tbl.read_tsv(data["weak_tsv"])
    # weak train / validation split (train_pretrained.py:241-253)
    split = config["training"].get("weak_split", 0.9)
    rng = np.random.default_rng(config["training"].get("seed", 42))
    n_weak = tbl.n_rows(weak_tsv)
    perm = rng.permutation(n_weak)
    n_train = int(n_weak * split)
    datasets["weak"] = WeakSet(
        data["weak_folder"], tbl.take(weak_tsv, perm[:n_train]), encoder,
        embeddings_hdf5_file=_emb_file(config, "weak_train"),
        mask_events_other_than=desed_mask, **common)
    roles.append(("weak", "weak"))

    datasets["unlabeled"] = UnlabeledSet(
        data["unlabeled_folder"], encoder,
        embeddings_hdf5_file=_emb_file(config, "unlabeled_train"),
        mask_events_other_than=desed_mask, **common)
    roles.append(("unlabeled", "unlabeled"))

    batch_sizes_list = config["training"]["batch_size"]
    if len(batch_sizes_list) != len(roles):
        raise ValueError(f"training.batch_size has {len(batch_sizes_list)} entries but "
                         f"{len(roles)} slots are configured: {[r[0] for r in roles]}")
    batch_sizes = {name: bs for (name, _), bs in zip(roles, batch_sizes_list)}
    slots = [SlotSpec(name, batch_sizes[name], role) for (name, role) in roles]
    if maestro_val_tsv is not None and tbl.n_rows(maestro_val_tsv):
        datasets["_maestro_val_tsv"] = maestro_val_tsv
    # the weak validation set rides along for the validator
    datasets["_weak_val"] = WeakSet(
        data["weak_folder"], tbl.take(weak_tsv, perm[n_train:]), encoder,
        embeddings_hdf5_file=_emb_file(config, "weak_train"), test=True, **common)
    return datasets, batch_sizes, slots


def mean_teacher_config(config: dict, slots, steps_per_epoch: int) -> MeanTeacherConfig:
    t = config["training"]
    slot_names = [s.name for s in slots]
    # mixup groups as the reference: weak alone, synth + strong together,
    # maestro alone (2024, sed_trainer_pretrained.py:349-363)
    groups = []
    if "weak" in slot_names:
        groups.append(("weak",))
    strong_group = tuple(n for n in ("synth", "strong") if n in slot_names)
    if strong_group:
        groups.append(strong_group)
    if "maestro" in slot_names:
        groups.append(("maestro",))
    decay = t.get("epoch_decay")
    return MeanTeacherConfig(
        slots=tuple(slots),
        mixup=t.get("mixup"),
        mixup_prob=t.get("mixup_prob", 0.5),
        mixup_groups=tuple(groups),
        const_max=t.get("const_max", 2.0),
        self_sup_loss=t.get("self_sup_loss", "mse"),
        consistency_start_slot=1 if "maestro" in slot_names else 0,
        rampup_steps=t.get("n_epochs_warmup", 50) * steps_per_epoch,
        decay_steps=decay * steps_per_epoch if decay else None,
        ema_factor=t.get("ema_factor", 0.999),
    )


def _maestro_gt(tsv):
    """The MAESTRO ground truth the metrics read: rows of confidence > 0.5
    (where the column exists) of the 11 evaluated classes."""
    from ..inference.io import read_ground_truth_events

    t = tbl.as_columns(tsv)
    keep = np.ones(tbl.n_rows(t), bool)
    if "confidence" in t:
        keep &= t["confidence"] > 0.5
    keep &= np.asarray([lab in CLASSES_MAESTRO_REAL_EVAL for lab in t["event_label"]], bool)
    return read_ground_truth_events(tbl.take(t, np.flatnonzero(keep)))


def single_run(
    config: dict,
    log_dir: str,
    checkpoint_resume: bool = False,
    test_from_checkpoint: str | None = None,
    fast_dev_run: bool = False,
    evaluation: bool = False,
    fast: bool = True,
    strong_real: bool = False,
    device: str | torch.device | None = None,
    run_info: dict | None = None,
):
    """Train (or test only) one system on `device` (default "cuda", on
    several ranks cuda:LOCAL_RANK). Returns (state, test_results);
    test_results is None on every rank but the first of several. A
    `run_info` dict, where given, receives the run's parts for inspection:
    loop, cache (None without the device train store), batcher, train_step
    (the step on host batches), step_fn (what the loop calls), predict_fn,
    encoder, mesh (None on one rank), and test_seconds (the test battery's
    wall time, when it ran)."""
    from ..parallel import init_distributed, make_mesh, rank_seed, replicate

    ranks = dist.is_initialized() or int(os.environ.get("WORLD_SIZE", 1)) > 1
    if ranks and device is None:
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
    device = resolve_device(device)  # no card: raise before joining a group
    joined = ranks and not dist.is_initialized()
    mesh = None
    if ranks:
        backend = "nccl" if device.type == "cuda" else "gloo"
        mesh = make_mesh({"data": init_distributed(backend)[1]})
    rank = 0 if mesh is None else dist.get_rank()
    root = rank == 0
    if device.type == "cuda" and device.index is not None:
        torch.cuda.set_device(device)
    t = config["training"]
    seed = t.get("seed", 42)
    seed_everything(seed)
    data = config["data"]

    encoder = build_encoder(config)
    model = build_model(config, fast=fast)
    mel = mel_config(config, fast=fast)
    scal = scaler_config(config)

    datasets, batch_sizes, slots = build_train_datasets(config, encoder, strong_real=strong_real)
    weak_val = datasets.pop("_weak_val")
    maestro_val_tsv = datasets.pop("_maestro_val_tsv", None)
    batcher = MultiSourceBatcher(datasets, batch_sizes, seed=seed,
                                 num_workers=1 if fast_dev_run else t.get("num_workers", 6))
    accumulate = int(t.get("accumulate_batches", 1))
    # schedules count optimizer steps (the reference's epoch_len divides by
    # accumulate_batches, train_pretrained.py:457-466)
    steps_per_epoch = 20 if fast_dev_run else max(batcher.steps_per_epoch // accumulate, 1)
    cfg = mean_teacher_config(config, slots, steps_per_epoch)
    tx, sched = make_optimizer(lr=config["opt"]["lr"], rampup_steps=cfg.rampup_steps,
                               max_grad_norm=t.get("gradient_clip", 5.0))

    sample = next(iter(batcher.epoch(steps=1)))
    scaler_state = None
    if scal.statistic == "dataset":
        from ..ops.frontend import log_mel_spectrogram

        def feats_of(b):
            audio = np.concatenate([b[s.name]["audio"] for s in slots])
            return log_mel_spectrogram(torch.as_tensor(audio, device=device), mel).cpu().numpy()

        scaler_state = fit_scaler(scal, batcher.epoch(steps=steps_per_epoch), feats_of)
    state = create_state(model, cfg, tx, device=device, scaler=scaler_state)
    if mesh is None:
        train_step = step_fn = make_train_step(cfg, tx, sched, mel_cfg=mel, scaler_cfg=scal,
                                               accumulate=accumulate)
    else:
        replicate([state.student, state.teacher], mesh)
        train_step = step_fn = make_train_step_sharded(
            cfg, tx, sched, mesh, sample, mel_cfg=mel, scaler_cfg=scal, accumulate=accumulate)

    # device-resident train store (data/device_cache.py): when the corpus
    # fits and needs no per-epoch random crop, a step moves only its row
    # indices to the card and gathers its batch there. Opt out with
    # training.device_cache: false.
    cache = None
    cache_mode = t.get("device_cache", "auto")
    if mesh is None and cache_mode in (True, "auto"):
        from ..data.device_cache import DeviceResidentData, fits_device_cache

        pad_samples = int(data["audio_max_len"] * data["fs"])
        budget = int(t.get("device_cache_max_bytes", 8 << 30))
        if cache_mode is True or fits_device_cache(datasets, pad_samples, budget):
            cache = DeviceResidentData.build(datasets, [s.name for s in slots],
                                             num_workers=t.get("num_workers", 6),
                                             verbose=not fast_dev_run, device=device)
            stores = cache.upload(verbose=not fast_dev_run)
            builder = cache.batch_builder(batch_sizes)

            def step_fn(state, idx, generator):  # noqa: F811: the store's path
                return train_step(state, builder(stores, idx), generator)

    predict_fn = make_predict_step(mel, scal)
    first = sample[slots[0].name]
    emb_frames = first["embeddings"].shape[-1] if "embeddings" in first else None
    n_frames = first["audio"].shape[-1] // mel.hop_length + 1
    if root:
        print(macs_report(model, n_frames, mel.n_mels, emb_frames), flush=True)

    # validation sets
    emb_type = (config.get("net") or {}).get("embedding_type")
    eval_kw = dict(pad_to=data["audio_max_len"], fs=data["fs"], test=True,
                   return_filename=True, embedding_type=emb_type)
    synth_val = StronglyAnnotatedSet(
        data["synth_val_folder"], tbl.read_tsv(data["synth_val_tsv"]), encoder,
        embeddings_hdf5_file=_emb_file(config, "synth_val"), **eval_kw)
    median = (config["net"] or {}).get("median_filter", 7)
    if isinstance(median, int):
        median = [median] * len(encoder.labels)
    maestro_val_set = maestro_gt = maestro_classes = None
    if maestro_val_tsv is not None:
        maestro_gt = _maestro_gt(maestro_val_tsv)
        maestro_classes = sorted(CLASSES_MAESTRO_REAL_EVAL)
        maestro_val_set = StronglyAnnotatedSet(
            data["real_maestro_train_folder"], maestro_val_tsv, encoder,
            embeddings_hdf5_file=_emb_file(config, "maestro_real_train"), **eval_kw)
    use_eval_cache = (cache is not None or mesh is not None) and t.get("device_cache_eval",
                                                                          True)
    if use_eval_cache:
        # the recurring validation passes (student and teacher, every N
        # epochs) also run from resident stores
        from ..data.device_cache import build_eval_caches

        wrapped = build_eval_caches(
            {"weak_val": weak_val, "synth_val": synth_val, "maestro_val": maestro_val_set},
            t.get("batch_size_val", 24), verbose=root and not fast_dev_run, mesh=mesh,
            device=device)
        weak_val, synth_val = wrapped["weak_val"], wrapped["synth_val"]
        maestro_val_set = wrapped["maestro_val"]

    validator = SEDValidator(
        predict_fn, encoder, weak_set=weak_val, synth_set=synth_val,
        maestro_set=maestro_val_set, maestro_gt=maestro_gt, maestro_classes=maestro_classes,
        synth_gt=tbl.read_tsv(data["synth_val_tsv"]),
        synth_dur=tbl.read_tsv(data["synth_val_dur"]) if "synth_val_dur" in data else None,
        batch_size=t.get("batch_size_val", 24), median_filter=median,
        obj_metric_synth_type=t.get("obj_metric_synth_type", "intersection"),
        desed_classes=list(CLASSES_DESED.keys()), trajectory_psds=t.get("trajectory_psds", 0))

    logger = energy = None
    if root:
        logger = MetricsLogger(log_dir)
        logger.log_hparams(config)
        energy = EnergyTracker("train", device_watts=t.get("device_watts"), out_dir=log_dir,
                               device=device, n_devices=1 if mesh is None else mesh.size)
    ckpt = CheckpointManager(Path(log_dir) / "checkpoints")
    loop = TrainLoop(
        step_fn, state, batcher,
        n_epochs=2 if fast_dev_run else t["n_epochs"],
        logger=logger, ckpt=ckpt, validate_fn=validator,
        validation_interval=1 if fast_dev_run else t.get("validation_interval", 10),
        early_stop_patience=t.get("early_stop_patience"),
        rng=torch.Generator(device=device).manual_seed(
            rank_seed(seed + 1, rank, 1 if mesh is None else mesh.size)),
        energy=energy, accumulate_batches=accumulate, index_cache=cache,
        # on when there is a card: counts and probes a stalled step
        watchdog=StallWatchdog(),
        log_every=t.get("log_every", 50),
        checkpoint_interval=t.get("checkpoint_interval"),
        mesh=mesh,
    )
    if run_info is not None:
        run_info.update(loop=loop, cache=cache, batcher=batcher, train_step=train_step,
                        step_fn=step_fn, predict_fn=predict_fn, encoder=encoder, mesh=mesh)

    test_results = None
    if test_from_checkpoint is not None:
        mgr = CheckpointManager(test_from_checkpoint)
        mgr.restore("best" if mgr.exists("best") else "last", state)
    else:
        if checkpoint_resume:
            loop.resume("last")
        loop.run()
        if ckpt.exists("best"):
            ckpt.restore("best", state)

    if (root and evaluation and data.get("eval_folder")
            and Path(data["eval_folder"]).exists()):
        # label-free eval, the first rank alone: raw and postprocessed score
        # files (the reference's on_test_epoch_end evaluation branch, :929-971)
        from ..inference.io import write_sed_scores
        from .evaluate import predict_dataset

        eval_set = UnlabeledSet(data["eval_folder"], encoder,
                                embeddings_hdf5_file=_emb_file(config, "eval"), **eval_kw)
        raw, post, _, _, _ = predict_dataset(
            predict_fn, state.student, eval_set, encoder, t.get("batch_size_val", 24),
            thresholds=(0.5,), median_filter=median, scaler=state.scaler)
        out = Path(log_dir) / "eval_scores" / "student"
        write_sed_scores(raw, out / "raw")
        write_sed_scores(post, out / "postprocessed")
        print(f"eval scores written for {len(raw)} clips -> {log_dir}/eval_scores", flush=True)

    if "test_folder" in data and not evaluation:
        test_set = StronglyAnnotatedSet(
            data["test_folder"], tbl.read_tsv(data["test_tsv"]), encoder,
            embeddings_hdf5_file=_emb_file(config, "devtest"), **eval_kw)
        maestro_test_kwargs = {}
        if (data.get("real_maestro_val_folder") and data.get("real_maestro_val_tsv")
                and Path(data["real_maestro_val_folder"]).exists()):
            m_tsv = tbl.read_tsv(data["real_maestro_val_tsv"])
            maestro_test_kwargs = dict(
                maestro_set=StronglyAnnotatedSet(
                    data["real_maestro_val_folder"], m_tsv, encoder,
                    embeddings_hdf5_file=_emb_file(config, "maestro_real_val"), **eval_kw),
                maestro_gt=_maestro_gt(m_tsv),
                maestro_classes=sorted(CLASSES_MAESTRO_REAL_EVAL),
            )
        if use_eval_cache:
            # the 50-threshold battery also runs from resident stores
            from ..data.device_cache import build_eval_caches

            wrapped = build_eval_caches(
                {"test": test_set, "maestro": maestro_test_kwargs.get("maestro_set")},
                t.get("batch_size_val", 24), verbose=root and not fast_dev_run, mesh=mesh,
                device=device)
            test_set = wrapped["test"]
            if maestro_test_kwargs:
                maestro_test_kwargs["maestro_set"] = wrapped["maestro"]
        t_test = time.perf_counter()
        test_results = run_test(
            predict_fn, state, test_set, encoder,
            tbl.read_tsv(data["test_tsv"]), tbl.read_tsv(data["test_dur"]),
            batch_size=t.get("batch_size_val", 24),
            n_thresholds=2 if fast_dev_run else t.get("n_test_thresholds", 50),
            median_filter=median, desed_classes=list(CLASSES_DESED.keys()),
            save_dir=Path(log_dir) / "figures" if root else None, **maestro_test_kwargs)
        if not root:  # a test set left on the host was scored on every rank
            test_results = None
        if run_info is not None:
            run_info["test_seconds"] = time.perf_counter() - t_test
        if root:
            logger.log_scalars(0, {
                "test/student/psds1": test_results["psds1"],
                "test/student/psds2": test_results["psds2"],
                "test/student/intersection_f1_macro": test_results["intersection_f1_macro"],
                "test/student/event_f1_macro": test_results["event_f1_macro"],
            })
    if root:
        logger.close()
    if joined:
        dist.destroy_process_group()
    return state, test_results
