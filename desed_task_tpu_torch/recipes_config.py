"""Model and trainer configurations of the DCASE recipes (counterpart of
desed_task_tpu/recipes_config.py)."""

from __future__ import annotations

from .models.crnn import CRNN
from .training.mean_teacher import MeanTeacherConfig, SlotSpec

# recipes/dcase2024_task4_baseline/confs/pretrained.yaml:87-110
CRNN_2024_NET = dict(
    nclass=27,
    attention=True,
    activation="glu",
    dropout=0.5,
    n_RNN_cell=192,
    n_layers_RNN=1,
    n_in_channel=1,
    kernel_size=[3] * 7,
    padding=[1] * 7,
    stride=[1] * 7,
    nb_filters=[16, 32, 64, 128, 128, 128, 128],
    pooling=[[2, 2], [2, 2], [1, 2], [1, 2], [1, 2], [1, 2], [1, 2]],
    dropstep_recurrent=0.3,
    dropstep_recurrent_len=16,
    use_embeddings=True,
    embedding_size=768,
    embedding_type="frame",
    aggregation_type="pool1d",
    specaugm_t_p=0.0,
    specaugm_t_l=5,
    specaugm_f_p=0.0,
    specaugm_f_l=10,
)

# the 2021-2023 CRNN, no embeddings (recipes/dcase2023_task4_baseline/confs/default.yaml net;
# recipes/dcase2021_task4_baseline/confs/sed.yaml has the same)
CRNN_2023_NET = dict(
    nclass=10,
    attention=True,
    activation="glu",
    dropout=0.5,
    n_RNN_cell=128,
    n_layers_RNN=2,
    n_in_channel=1,
    kernel_size=[3] * 7,
    padding=[1] * 7,
    stride=[1] * 7,
    nb_filters=[16, 32, 64, 128, 128, 128, 128],
    pooling=[[2, 2], [2, 2], [1, 2], [1, 2], [1, 2], [1, 2], [1, 2]],
)

# 2024 per-class median filter windows (pretrained.yaml:110)
MEDIAN_2024 = [3, 9, 9, 5, 5, 5, 9, 7, 11, 9, 7, 3, 9, 13, 7, 1, 13, 3, 13, 7,
               5, 5, 1, 13, 17, 13, 15]


def crnn_2024(**over) -> CRNN:
    """The 2024 flagship CRNN (128 mels, 768-d BEATs frame embeddings fused
    by pool1d), with `over` replacing any configuration key."""
    cfg = dict(CRNN_2024_NET)
    cfg.update(over)
    return CRNN(**cfg)


def crnn_2023(**over) -> CRNN:
    """The 2021-2023 baseline CRNN (128 mels, a 2-layer BiGRU of 128 cells,
    10 DESED classes), with `over` replacing any configuration key."""
    cfg = dict(CRNN_2023_NET)
    cfg.update(over)
    return CRNN(**cfg)


def mean_teacher_2024(batch_scale: int = 1, steps_per_epoch: int = 118) -> MeanTeacherConfig:
    """5-slot 2024 config (pretrained.yaml:8, training section).

    batch_scale multiplies every slot (per-device batch stays at the
    reference's [12, 6, 6, 12, 24])."""
    s = batch_scale
    return MeanTeacherConfig(
        slots=(
            SlotSpec("maestro", 12 * s, "strong"),
            SlotSpec("synth", 6 * s, "strong"),
            SlotSpec("strong", 6 * s, "strong"),
            SlotSpec("weak", 12 * s, "weak"),
            SlotSpec("unlabeled", 24 * s, "unlabeled"),
        ),
        mixup="soft",
        mixup_prob=0.5,
        # reference mixes weak, synth+strong, maestro (sed_trainer:349-363)
        mixup_groups=(("weak",), ("synth", "strong"), ("maestro",)),
        const_max=2.0,
        self_sup_loss="mse",
        consistency_start_slot=1,  # mask_unlabeled = maestro-onward slots
        rampup_steps=50 * steps_per_epoch,  # n_epochs_warmup: 50
        decay_steps=100 * steps_per_epoch,  # epoch_decay: 100
        ema_factor=0.999,
    )


def mean_teacher_2021(batch_sizes=(24, 24, 48), steps_per_epoch: int = 100) -> MeanTeacherConfig:
    """3-slot 2021 config [synth, weak, unlabeled] (2021 sed_trainer.py:230-246)."""
    return MeanTeacherConfig(
        slots=(
            SlotSpec("synth", batch_sizes[0], "strong"),
            SlotSpec("weak", batch_sizes[1], "weak"),
            SlotSpec("unlabeled", batch_sizes[2], "unlabeled"),
        ),
        mixup="soft",
        mixup_prob=0.5,
        mixup_groups=(("weak",), ("synth",)),
        const_max=2.0,
        self_sup_loss="mse",
        consistency_start_slot=0,  # 2021: consistency over the whole batch
        rampup_steps=50 * steps_per_epoch,
        decay_steps=None,
        ema_factor=0.999,
        weak_labels_post_mixup=False,  # 2021 mixes weak targets directly
    )
