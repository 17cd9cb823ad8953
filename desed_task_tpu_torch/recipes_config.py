"""Model configurations of the DCASE recipes (counterpart of
desed_task_tpu/recipes_config.py; the training configs are not ported yet)."""

from __future__ import annotations

from .models.crnn import CRNN

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

# 2024 per-class median filter windows (pretrained.yaml:110)
MEDIAN_2024 = [3, 9, 9, 5, 5, 5, 9, 7, 11, 9, 7, 3, 9, 13, 7, 1, 13, 3, 13, 7,
               5, 5, 1, 13, 17, 13, 15]


def crnn_2024(**over) -> CRNN:
    """The 2024 flagship CRNN (128 mels, 768-d BEATs frame embeddings fused
    by pool1d), with `over` replacing any configuration key."""
    cfg = dict(CRNN_2024_NET)
    cfg.update(over)
    return CRNN(**cfg)
