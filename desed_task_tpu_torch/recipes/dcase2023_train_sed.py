"""DCASE 2023 Task 4 baseline on the card: CRNN mean teacher over synthetic, weak
and unlabeled DESED, with --strong_real (counterpart of
recipes/dcase2023_task4_baseline/train_sed.py).

    python -m desed_task_tpu_torch.recipes.dcase2023_train_sed \\
        [--conf_file CONF] [--log_dir DIR] [--fast_dev_run] [--strong_real] \\
        [--resume_from_checkpoint] [--test_from_checkpoint DIR] \\
        [--eval_from_checkpoint DIR] [--no_fast_math]

The default conf is recipes/dcase2023_task4_baseline/confs/default.yaml of this
repository; its data paths are relative to that recipe's folder, as in the
reference.
"""

from __future__ import annotations

from pathlib import Path

from ..utils.cli import train_cli

DEFAULT_CONF = (Path(__file__).resolve().parents[2] / "recipes" / "dcase2023_task4_baseline"
                / "confs" / "default.yaml")


def main(argv=None, run_info: dict | None = None):
    return train_cli("Training a SED system for DESED Task", default_conf=str(DEFAULT_CONF),
                     default_log_dir="./exp/2023_baseline", strong_real=True, argv=argv,
                     run_info=run_info)


if __name__ == "__main__":
    main()
