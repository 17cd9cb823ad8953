"""The eval traffic: repeated whole passes of the validation forward over a
device-resident eval set, as `SEDValidator` runs them:
`_predict_cache_all(make_predict_step(mel, scaler), model, cache, scaler,
median_filter, want_raw=False)` (the forward, the on-device median filter,
one copy to the host a pass).

Set-up builds a `DeviceEvalCache` through its own constructor and upload
(zero clips), fills its stores on the device from the seed, loads the
seeded weights with BatchNorm statistics taken from the first
`calibration_clips` clips of the set (`inputs.with_data_statistics`, so
that the scores differ from clip to clip as a trained model's do), and
warms up with whole passes. The window runs passes
until `--seconds` have passed. The check compares the pass drawn from the
seed among the first ones and the last pass, every clip, with the
reference's fp32 forward over the same clips made again from the seed.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import inputs
from ..reference.model import exact, fp32_math
from ..reference.step import eval_forward, median_windows
from ..trace import span

FAULTS = ("answer_altered", "half_batch", "row_shift")


class _ZeroClips:
    """A dataset of n silent clips of the configuration's shapes."""

    def __init__(self, config: dict, n: int):
        s = inputs.clip_shapes(config)
        self.n = n
        self.item = {"audio": np.zeros(s["audio"], np.float32),
                     "labels": np.zeros(s["labels"], np.float32)}
        if s["embeddings"] is not None:
            self.item["embeddings"] = np.zeros(s["embeddings"], np.float32)

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {**self.item, "filename": f"clip_{i}.wav"}


class Cell:
    kind = "eval"
    traced_metrics = ("eval_device_ms",)  # read from a profiled block after the window

    def __init__(self, config: dict, traffic: dict, seed: int, device, fault: str | None = None):
        if fault not in (None, *FAULTS):
            raise ValueError(f"unknown fault {fault!r}")
        self.config, self.traffic, self.device = config, traffic, torch.device(device)
        self.seeds = inputs.seeds(seed)
        self.fault = fault
        self.n = traffic["clips"]
        self.median = median_windows(config)
        # the pass whose answers are checked besides the last one
        self.check_pass = int(np.random.default_rng(self.seeds["rows"]).integers(0, 3))

    def setup(self):
        from desed_task_tpu_torch.data.device_cache import DeviceEvalCache
        from desed_task_tpu_torch.training.evaluate import _predict_cache_all
        from desed_task_tpu_torch.training.mean_teacher import make_predict_step
        from desed_task_tpu_torch.training.single_run import (build_model, mel_config,
                                                              scaler_config)

        c, dev = self.config, self.device
        fast = c["compute_dtype"] == "bfloat16"
        data = inputs.make_clips(c, self.n, self.seeds["data"], dev,
                                 fields=("audio", "embeddings"))
        k = min(self.traffic["calibration_clips"], self.n)
        self.weights = inputs.with_data_statistics(
            inputs.make_weights(c, self.seeds["weights"], dev), c, data["audio"][:k],
            data["embeddings"][:k] if "embeddings" in data else None)
        model = build_model(c, fast=fast)
        model.load_state_dict(self.weights, strict=True)
        self.model = model.to(dev)
        predict = make_predict_step(mel_config(c, fast=fast), scaler_config(c))
        self.predict = self._planted(predict) if self.fault else predict
        self.cache = DeviceEvalCache(_ZeroClips(c, self.n), c["training"]["batch_size_val"],
                                     device=dev)
        self.cache.upload()
        for k, v in data.items():
            self.cache.stores[k][: self.n].copy_(v)
        del data
        self._pass = _predict_cache_all
        self.kept = {}
        for _ in range(self.traffic["warmup_passes"]):
            self.run_pass()

    def _planted(self, predict):
        """The timed path broken underneath, for the tests of the check."""
        def broken(model, audio, embeddings=None, scaler=None, pad_mask=None):
            if self.fault == "half_batch":  # the second half answered with the first's clips
                h = audio.shape[0] // 2
                audio = torch.cat([audio[:h], audio[:audio.shape[0] - h]])
                if embeddings is not None:
                    embeddings = torch.cat([embeddings[:h], embeddings[:embeddings.shape[0] - h]])
            strong, weak = predict(model, audio, embeddings, scaler, pad_mask)
            if self.fault == "answer_altered":  # a clip's answer a batch lost where it is made
                strong, weak = strong.clone(), weak.clone()
                strong[0], weak[0] = 0.0, 0.0
            if self.fault == "row_shift":  # every answer served to the next clip
                strong, weak = strong.roll(1, 0), weak.roll(1, 0)
            return strong, weak
        return broken

    def run_pass(self):
        """One pass over the cache; keeps the answers of the passes checked."""
        with span("pass"):
            _, post, weak = self._pass(self.predict, self.model, self.cache, None, self.median,
                                       want_raw=False)
        return post, weak

    def window(self, seconds: float) -> dict:
        times, failed = [], 0
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        t_start = time.perf_counter()
        while True:
            post, weak = self.run_pass()
            t = time.perf_counter()
            times.append(t)
            if len(times) - 1 == self.check_pass:
                self.kept["drawn"] = (post, weak)
            failed += int(not (np.isfinite(post).all() and np.isfinite(weak).all()))
            if t - t_start >= seconds:
                break
        self.kept["last"] = (post, weak)
        peak = torch.cuda.max_memory_allocated() if self.device.type == "cuda" else 0
        return {"units": len(times), "window_s": times[-1] - t_start, "clips": len(times) * self.n,
                "failed": failed, "peak_bytes": peak}

    def end_to_end(self, win: dict, setup_s: float, trace=None) -> dict:
        """This kind's end-to-end values of a window and of the profiled
        block after it, where there is one (run.py keeps those that
        BENCHMARK.json gives the cell). `eval_device_ms`: the device's busy
        milliseconds a pass, kernels and copies merged where they overlap."""
        busy = trace.busy_s() if trace is not None and trace.device else None
        return {"setup_s": setup_s, "peak_mem_gib": win["peak_bytes"] / 2**30,
                "eval_clips_per_s": win["clips"] / win["window_s"],
                "eval_device_ms": None if busy is None else 1e3 * busy / trace.units}

    def trace_units(self) -> int:
        return self.traffic["trace_passes"]

    def run_unit(self):
        self.run_pass()

    def free(self):
        self.model = self.cache = self.predict = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def program_result(self) -> dict:
        return {"passes": list(self.kept.values())}

    def reference_result(self, q=exact) -> dict:
        """The reference's filtered frame scores and weak scores of every
        clip, made again from the seed, at precision `q`."""
        c, dev = self.config, self.device
        data = inputs.make_clips(c, self.n, self.seeds["data"], dev,
                                 fields=("audio", "embeddings"))
        cmask = torch.ones((1, c["net"]["nclass"]), dtype=torch.bool, device=dev)
        blk = self.traffic["reference_block"]
        posts, weaks = [], []
        with fp32_math(), torch.no_grad():
            for a in range(0, self.n, blk):
                b = min(a + blk, self.n)
                emb = data["embeddings"][a:b] if "embeddings" in data else None
                p, w = eval_forward(self.weights, c, data["audio"][a:b].float() / 32768.0, emb,
                                    cmask.expand(b - a, -1), q)
                posts.append(p.cpu().numpy())
                weaks.append(w.cpu().numpy())
        return {"passes": [(np.concatenate(posts), np.concatenate(weaks))]}

    def check(self, q=exact) -> dict:
        return compare(self.program_result(), self.reference_result(q))


def compare(got: dict, ref: dict) -> dict:
    """Over the passes checked: the mean gap of the filtered frame scores
    from the reference's (`mean_gap`) and of the weak scores (`weak_gap`),
    the worst clip's mean gap of its frame scores (`clip_gap`), its
    root-mean-square gap, and the widest gap of any frame or weak score.
    The cell's file names those compared."""
    ref_post, ref_weak = ref["passes"][0]
    out = dict.fromkeys(("score_gap", "clip_rms_gap", "clip_gap", "mean_gap", "weak_gap"), 0.0)
    for post, weak in got["passes"]:
        d = np.abs(post - ref_post)
        now = {"score_gap": max(float(d.max()), float(np.abs(weak - ref_weak).max())),
               "clip_rms_gap": float(np.sqrt((d ** 2).mean(axis=(1, 2))).max()),
               "clip_gap": float(d.mean(axis=(1, 2)).max()), "mean_gap": float(d.mean()),
               "weak_gap": float(np.abs(weak - ref_weak).mean())}
        out = {k: max(v, now[k]) for k, v in out.items()}
    return out
