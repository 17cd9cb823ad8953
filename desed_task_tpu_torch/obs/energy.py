"""Energy accounting (counterpart of desed_task_tpu/obs/energy.py; stands in
for the reference's CodeCarbon tracker, sed_trainer_pretrained.py:171-181,
1332-1363).

A model-based estimate, labelled as one. The train loop records the
train-step windows (`record_busy`); busy time bills at the device's watts,
the rest of the wall time at `idle_fraction` of them, and the host's watts
run throughout. The busy window is an upper bound on device activity (a
step stalled on data still bills as busy).

The device's watts: on the card, its power limit as `nvidia-smi
--query-gpu=name,power.limit --format=csv,noheader` reports it, read once
at `start()`. The limit bounds the card's draw from above, so the estimate
brackets the energy from above; the report names the card and the limit.
If nvidia-smi cannot be read there, the tracker raises: it does not carry
on with a made-up figure. Off the card (device "cpu") the caller passes
`device_watts`. The host's watts and the idle fraction keep the JAX
package's brackets (50-150 W, 0.05-0.30), which are conventions of
CodeCarbon's host accounting and of accelerator idle floors, not a TPU's.

A data-parallel run bills every card of it: the device's watts count
`n_devices` times (energy.py:55 and :129 of the JAX package); the run's
first rank alone keeps the tracker, and reads the limit of its own card.
"""

from __future__ import annotations

import json
import subprocess
import time
from pathlib import Path

import torch


def card_power_limit(index: int = 0) -> tuple[str, float]:
    """(name, power limit in W) of card `index`, from nvidia-smi; raises
    RuntimeError when nvidia-smi cannot be run or read."""
    cmd = ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
           f"--id={index}"]
    try:
        out = subprocess.run(cmd, capture_output=True, text=True, timeout=60, check=True)
        name, limit = out.stdout.strip().splitlines()[0].rsplit(",", 1)
        return name.strip(), float(limit.strip().split()[0])
    except (OSError, subprocess.SubprocessError, IndexError, ValueError) as e:
        raise RuntimeError(f"cannot read the card's power limit from nvidia-smi: {e}") from e


class EnergyTracker:
    def __init__(
        self,
        name: str = "train",
        device_watts: float | None = None,
        host_watts: float = 100.0,
        idle_fraction: float = 0.15,
        out_dir=None,
        device_watts_range: tuple | None = None,
        host_watts_range: tuple = (50.0, 150.0),
        idle_fraction_range: tuple = (0.05, 0.30),
        device: str | torch.device = "cuda",
        n_devices: int = 1,
    ):
        self.name = name
        self.n_devices = n_devices
        self.device = torch.device(device)
        if device_watts is None and self.device.type != "cuda":
            raise ValueError("off the card, pass device_watts")
        self.device_watts = device_watts
        self.device_watts_range = device_watts_range
        self.host_watts = host_watts
        self.idle_fraction = idle_fraction
        self.host_watts_range = host_watts_range
        self.idle_fraction_range = idle_fraction_range
        self.out_dir = Path(out_dir) if out_dir else None
        self.card = None
        self.power_limit_w = None
        self._start = None
        self._elapsed = 0.0
        self._busy = 0.0

    def start(self):
        if self.device.type == "cuda" and self.card is None:
            self.card, self.power_limit_w = card_power_limit(self.device.index or 0)
            if self.device_watts is None:
                self.device_watts = self.power_limit_w
        if self.device_watts_range is None:
            self.device_watts_range = (self.device_watts, self.device_watts)
        self._start = time.monotonic()
        return self

    def record_busy(self, seconds: float):
        """Accumulate device-busy seconds (train-step windows)."""
        self._busy += float(seconds)

    def stop(self) -> float:
        """Returns the estimated kWh; writes energy_<name>.json if out_dir."""
        if self._start is not None:
            self._elapsed += time.monotonic() - self._start
            self._start = None
        kwh = self.energy_kwh
        if self.out_dir:
            self.out_dir.mkdir(parents=True, exist_ok=True)
            (self.out_dir / f"energy_{self.name}.json").write_text(json.dumps({
                "name": self.name,
                "card": self.card,
                "power_limit_w": self.power_limit_w,
                "n_devices": self.n_devices,
                "elapsed_s": self._elapsed,
                "busy_s": self._busy,
                "device_watts": self.device_watts,
                "host_watts": self.host_watts,
                "idle_fraction": self.idle_fraction,
                "estimated_kwh": kwh,
                "estimated_kwh_range": list(self.energy_kwh_range),
                "device_watts_range": list(self.device_watts_range),
                "host_watts_range": list(self.host_watts_range),
                "idle_fraction_range": list(self.idle_fraction_range),
                "note": ("model-based estimate: busy time at device_watts, idle wall time"
                         " at idle_fraction*device_watts, host_watts throughout; busy is"
                         " an upper bound on device activity; on the card device_watts is"
                         " its power limit (nvidia-smi), an upper bound on its draw;"
                         " device energy counts n_devices cards"),
            }))
        return kwh

    def _kwh(self, device_watts: float, host_watts: float, idle_fraction: float) -> float:
        elapsed = self._elapsed
        if self._start is not None:
            elapsed += time.monotonic() - self._start
        busy = min(self._busy, elapsed)
        if self._busy == 0.0:
            busy = elapsed  # no duty-cycle record: bill everything as busy
        idle = elapsed - busy
        device_j = device_watts * self.n_devices * (busy + idle_fraction * idle)
        return (device_j + host_watts * elapsed) / 3600.0 / 1000.0

    @property
    def energy_kwh(self) -> float:
        return self._kwh(self.device_watts, self.host_watts, self.idle_fraction)

    @property
    def energy_kwh_range(self) -> tuple:
        """[lo, hi] kWh over the brackets of the power constants."""
        return (
            self._kwh(self.device_watts_range[0], self.host_watts_range[0],
                      self.idle_fraction_range[0]),
            self._kwh(self.device_watts_range[1], self.host_watts_range[1],
                      self.idle_fraction_range[1]),
        )
