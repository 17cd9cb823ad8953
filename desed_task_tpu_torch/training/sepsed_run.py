"""End-to-end 2021 separation-ensemble fine-tune (counterpart of
desed_task_tpu/training/sepsed_run.py; reference
recipes/dcase2021_task4_baseline/finetune_on_separated.py:24-387 and
local/sepsed_trainer.py:200-320).

A trained monaural 2021 CRNN is restored from the port's checkpoint (train
any 2021-2023 SED recipe first) into a frozen "mixture" branch, and
grafted into a trainable multisrc copy whose BatchNorm is frozen
(`freeze_bn`: its conv stack runs on the running statistics while
gradients flow). The ensemble (models/ensemble.py) is fine-tuned on
pre-separated sources by the mean-teacher step of training/sepsed.py,
validated on the separated synth and weak sets, and tested with the PSDS
battery on the teacher.

Separated data layout: for each base clip X.wav the separation runner
(tools/separation.py `separate_folder`) writes X_src{i}.wav into
<folder>_separated, or into the folder an explicit `data.<key>_sep` names.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from ..data.batcher import MultiSourceBatcher
from ..data.datasets import SeparatedSet, StronglyAnnotatedSet, UnlabeledSet, WeakSet
from ..device import resolve_device
from ..models.crnn import CRNN
from ..models.ensemble import EnsembleModel
from ..obs.checkpoint import CheckpointManager
from ..obs.logging import MetricsLogger
from ..utils import table as tbl
from .evaluate import SEDValidator, run_test
from .loop import TrainLoop
from .mean_teacher import MeanTeacherConfig, SlotSpec, create_state, make_optimizer
from .sepsed import make_sepsed_predict_step, make_sepsed_train_step
from .single_run import build_encoder, build_model, mel_config, scaler_config, seed_everything


def _sep_folder(data: dict, key: str) -> str:
    """The separated folder of a base-folder config key: an explicit
    `<key>_sep` entry, else the separation runner's `<folder>_separated`."""
    if f"{key}_sep" in data:
        return data[f"{key}_sep"]
    return str(Path(data[key]).parent / (Path(data[key]).name + "_separated"))


def build_ensemble(config: dict, sed_checkpoint: str, sed_model: str = "student"
                   ) -> EnsembleModel:
    """The ensemble of config["net"] from a trained monaural SED checkpoint
    directory (its `best`, else `last`; the `sed_model` branch): the frozen
    monaural CRNN, and the trainable multisrc copy with frozen BatchNorm,
    both starting from the checkpoint's weights and BN statistics
    (reference finetune_on_separated.py:137-147)."""
    mgr = CheckpointManager(sed_checkpoint)
    name = "best" if mgr.exists("best") else "last"
    if not mgr.exists(name):
        raise FileNotFoundError(f"no checkpoint under {sed_checkpoint}; train a SED recipe first")
    if sed_model not in ("student", "teacher"):
        raise ValueError(f"sed_model must be student|teacher, got {sed_model}")
    mono_state = mgr.load(name)[sed_model]
    monaural = build_model(config, fast=False)
    monaural.load_state_dict(mono_state)
    net = {k: v for k, v in config["net"].items() if k != "median_filter"}
    multisrc = CRNN(n_mels=config["feats"]["n_mels"], **net, freeze_bn=True)
    multisrc.load_state_dict(mono_state)
    return EnsembleModel(multisrc, monaural)


def sepsed_single_run(
    config: dict,
    log_dir: str,
    sed_checkpoint: str,
    sed_model: str = "student",
    n_src: int = 4,
    fast_dev_run: bool = False,
    test_from_checkpoint: str | None = None,
    device: str | torch.device | None = None,
    run_info: dict | None = None,
):
    """Fine-tune the separation ensemble on `device` (default "cuda").
    Returns (state, test_results). A `run_info` dict, where given, receives
    the run's loop, batcher, train_step and predict_fn."""
    device = resolve_device(device)
    t = config["training"]
    seed = t.get("seed", 42)
    seed_everything(seed)
    data = config["data"]

    encoder = build_encoder(config)
    mel = mel_config(config, fast=False)
    scal = scaler_config(config)

    ensemble = build_ensemble(config, sed_checkpoint, sed_model)

    # ---- separated datasets, 3 fixed slots (reference :152-205) ----
    common = dict(pad_to=data["audio_max_len"], fs=data["fs"])
    synth_tsv = tbl.read_tsv(data["synth_tsv"])
    weak_tsv = tbl.read_tsv(data["weak_tsv"])
    rng = np.random.default_rng(seed)
    n_weak = tbl.n_rows(weak_tsv)
    perm = rng.permutation(n_weak)
    n_train = int(n_weak * t.get("weak_split", 0.9))

    def sep(base, folder_key):
        return SeparatedSet(_sep_folder(data, folder_key), base, n_src=n_src,
                            sources_as_audio=True)

    datasets = {
        "synth": sep(StronglyAnnotatedSet(data["synth_folder"], synth_tsv, encoder, **common),
                     "synth_folder"),
        "weak": sep(WeakSet(data["weak_folder"], tbl.take(weak_tsv, perm[:n_train]), encoder,
                            **common), "weak_folder"),
        "unlabeled": sep(UnlabeledSet(data["unlabeled_folder"], encoder, **common),
                         "unlabeled_folder"),
    }
    batch_sizes = dict(zip(("synth", "weak", "unlabeled"), t["batch_size"]))
    batcher = MultiSourceBatcher(datasets, batch_sizes, seed=seed,
                                 num_workers=1 if fast_dev_run else t.get("num_workers", 6))
    steps_per_epoch = 20 if fast_dev_run else batcher.steps_per_epoch
    cfg = MeanTeacherConfig(
        slots=tuple(SlotSpec(n, batch_sizes[n], role) for n, role in
                    (("synth", "strong"), ("weak", "weak"), ("unlabeled", "unlabeled"))),
        mixup=None,  # the reference's fine-tune applies no mixup
        const_max=t.get("const_max", 2.0),
        self_sup_loss=t.get("self_sup_loss", "mse"),
        consistency_start_slot=0,  # 2021: the whole batch
        rampup_steps=t.get("n_epochs_warmup", 50) * steps_per_epoch,
        ema_factor=t.get("ema_factor", 0.999),
        weak_labels_post_mixup=False,
    )
    tx, sched = make_optimizer(lr=config["opt"]["lr"], rampup_steps=cfg.rampup_steps,
                               max_grad_norm=t.get("gradient_clip", 5.0))
    # the JAX run initialises its state from a sample batch: draw it too, so
    # that the slots' streams stay those of the JAX run
    next(iter(batcher.epoch(steps=1)))
    state = create_state(ensemble, cfg, tx, device=device)
    train_step = make_sepsed_train_step(cfg, tx, sched, mel, scal)
    predict_fn = make_sepsed_predict_step(mel, scal)

    # ---- validation on the separated synth_val and weak_val ----
    synth_val_tsv = tbl.read_tsv(data["synth_val_tsv"])
    synth_val = sep(StronglyAnnotatedSet(data["synth_val_folder"], synth_val_tsv, encoder,
                                         test=True, return_filename=True, **common),
                    "synth_val_folder")
    weak_val = sep(WeakSet(data["weak_folder"], tbl.take(weak_tsv, perm[n_train:]), encoder,
                           test=True, **common), "weak_folder")
    median = config["net"].get("median_filter", 7)
    if isinstance(median, int):
        median = [median] * len(encoder.labels)
    validator = SEDValidator(
        predict_fn, encoder, weak_set=weak_val, synth_set=synth_val, synth_gt=synth_val_tsv,
        synth_dur=tbl.read_tsv(data["synth_val_dur"]) if "synth_val_dur" in data else None,
        batch_size=t.get("batch_size_val", 24), median_filter=median,
        obj_metric_synth_type=t.get("obj_metric_synth_type", "intersection"))
    logger = MetricsLogger(log_dir)
    logger.log_hparams(config)
    ckpt = CheckpointManager(Path(log_dir) / "checkpoints")
    loop = TrainLoop(
        train_step, state, batcher,
        n_epochs=2 if fast_dev_run else t["n_epochs"],
        logger=logger, ckpt=ckpt, validate_fn=validator,
        validation_interval=1 if fast_dev_run else t.get("validation_interval", 10),
        early_stop_patience=t.get("early_stop_patience"),
        rng=torch.Generator(device=device).manual_seed(seed + 1),
        checkpoint_interval=t.get("checkpoint_interval"),
    )
    if run_info is not None:
        run_info.update(loop=loop, batcher=batcher, train_step=train_step,
                        predict_fn=predict_fn)
    if test_from_checkpoint is not None:
        tmgr = CheckpointManager(test_from_checkpoint)
        tmgr.restore("best" if tmgr.exists("best") else "last", state)
    else:
        loop.run()
        if ckpt.exists("best"):
            ckpt.restore("best", state)

    test_results = None
    if data.get("test_tsv") and data.get("test_folder"):
        test_tsv = tbl.read_tsv(data["test_tsv"])
        test_set = sep(StronglyAnnotatedSet(data["test_folder"], test_tsv, encoder, test=True,
                                            return_filename=True, **common), "test_folder")
        test_results = run_test(
            predict_fn, state, test_set, encoder, test_tsv, tbl.read_tsv(data["test_dur"]),
            batch_size=t.get("batch_size_val", 24),
            n_thresholds=3 if fast_dev_run else t.get("n_test_thresholds", 50),
            median_filter=median,
            use_teacher=True,  # 2021 reports the teacher (README.md:71-73)
            save_dir=log_dir,
        )
    return state, test_results
