"""Metrics logging: CSV, and TensorBoard where tensorboardX can be imported
(counterpart of desed_task_tpu/obs/logging.py; the same metrics.csv and
hparams.json).

Replaces the reference's Lightning TensorBoardLogger and self.log channels
(train_pretrained.py:483-488, sed_trainer_pretrained.py:420-428).
"""

from __future__ import annotations

import csv
import json
import time
from pathlib import Path


class MetricsLogger:
    def __init__(self, log_dir, use_tensorboard: bool = True):
        self.log_dir = Path(log_dir)
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self._csv_path = self.log_dir / "metrics.csv"
        self._csv_file = open(self._csv_path, "a", newline="")
        self._csv = csv.writer(self._csv_file)
        if self._csv_path.stat().st_size == 0:
            self._csv.writerow(["time", "step", "name", "value"])
        self._tb = None
        if use_tensorboard:
            try:
                from tensorboardX import SummaryWriter
            except ImportError:
                pass
            else:
                self._tb = SummaryWriter(str(self.log_dir))

    def log_hparams(self, hparams: dict):
        (self.log_dir / "hparams.json").write_text(json.dumps(hparams, default=str))
        if self._tb is not None:
            flat = {
                f"{k}/{k2}": v2
                for k, v in hparams.items()
                if isinstance(v, dict)
                for k2, v2 in v.items()
                if isinstance(v2, (int, float, str, bool))
            }
            self._tb.add_hparams(flat, {})

    def log_scalars(self, step: int, scalars: dict):
        """One row a scalar; values that float() cannot take are skipped.
        Pass host numbers: float() of a tensor on the card waits for it."""
        now = time.time()
        for name, value in scalars.items():
            try:
                value = float(value)
            except (TypeError, ValueError):
                continue
            self._csv.writerow([f"{now:.3f}", step, name, value])
            if self._tb is not None:
                self._tb.add_scalar(name, value, step)
        self._csv_file.flush()

    def close(self):
        self._csv_file.close()
        if self._tb is not None:
            self._tb.close()
