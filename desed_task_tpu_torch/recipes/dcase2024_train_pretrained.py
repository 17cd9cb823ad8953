"""DCASE 2024 Task 4 baseline on the card: CRNN + frozen BEATs embeddings,
mean teacher over DESED + MAESTRO (counterpart of
recipes/dcase2024_task4_baseline/train_pretrained.py).

    python -m desed_task_tpu_torch.recipes.dcase2024_train_pretrained \\
        [--conf_file CONF] [--log_dir DIR] [--fast_dev_run] \\
        [--resume_from_checkpoint] [--test_from_checkpoint DIR] \\
        [--eval_from_checkpoint DIR] [--no_fast_math]

The default conf is recipes/dcase2024_task4_baseline/confs/pretrained.yaml
of this repository; its data paths are relative to that recipe's folder,
as in the reference.
"""

from __future__ import annotations

from pathlib import Path

from ..utils.cli import train_cli

DEFAULT_CONF = (Path(__file__).resolve().parents[2] / "recipes" / "dcase2024_task4_baseline"
                / "confs" / "pretrained.yaml")


def main(argv=None):
    return train_cli("Training a SED system for DESED + MAESTRO", default_conf=str(DEFAULT_CONF),
                     default_log_dir="./exp/2024_baseline", argv=argv)


if __name__ == "__main__":
    main()
