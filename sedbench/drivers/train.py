"""The train traffic: the recipe's mean-teacher step through the device
store, as `single_run` wires it (`step_fn = train_step(state,
builder(stores, idx), generator)`), one scalar fetch a step as
`TrainLoop.run` does.

Set-up builds the store on the device (filled to the traffic's byte
budget), the student, teacher and optimizer state from the seeded weights,
and the step; it then drives the first `checked_steps` steps through the
window's own call on rows that all differ (one epoch's permutation),
keeping what the check compares, and warms up. The window then runs steps
until `--seconds` have passed. After it the program's state is freed and
the reference follows the checked steps from the same seeded weights,
rows and generator seed.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import inputs
from ..reference.model import exact, fp32_math, is_statistic
from ..reference.step import MeanTeacherReference, leaf_gaps, leaf_norms, worst_leaf_gap
from ..trace import span

FAULTS = ("state_unchanged", "half_batch", "loss_altered")


class Cell:
    kind = "train"
    traced_metrics = ("train_device_ms",)  # read from a profiled block after the window

    def __init__(self, config: dict, traffic: dict, seed: int, device, fault: str | None = None):
        if fault not in (None, *FAULTS):
            raise ValueError(f"unknown fault {fault!r}")
        self.config, self.traffic, self.device = config, traffic, torch.device(device)
        self.seeds = inputs.seeds(seed)
        self.fault = fault
        self.clips = sum(s["size"] for s in config["slots"])

    # ------------------------------------------------------------ set-up
    def setup(self):
        from desed_task_tpu_torch.data.device_cache import DeviceResidentData
        from desed_task_tpu_torch.training.mean_teacher import (SlotSpec, create_state,
                                                                make_optimizer, make_train_step)
        from desed_task_tpu_torch.training.single_run import (build_model, mean_teacher_config,
                                                              mel_config, scaler_config)

        c, t, dev = self.config, self.config["training"], self.device
        fast = c["compute_dtype"] == "bfloat16"
        self.weights = inputs.make_weights(c, self.seeds["weights"], dev)
        model = build_model(c, fast=fast)
        model.load_state_dict(self.weights, strict=True)
        slots = [SlotSpec(s["name"], s["size"], s["role"]) for s in c["slots"]]
        cfg = mean_teacher_config(c, slots, c["steps_per_epoch"])
        tx, sched = make_optimizer(lr=c["opt"]["lr"], rampup_steps=cfg.rampup_steps,
                                   max_grad_norm=t.get("gradient_clip", 5.0))
        self.state = create_state(model, cfg, tx, device=dev)
        self.train_step = make_train_step(cfg, tx, sched, mel_cfg=mel_config(c, fast=fast),
                                          scaler_cfg=scaler_config(c),
                                          accumulate=int(t.get("accumulate_batches", 1)))
        self.rows = inputs.store_rows(c, self.traffic["store_bytes"])
        self.stores = inputs.make_clips(c, sum(self.rows.values()), self.seeds["data"], dev)
        names = [s.name for s in slots]
        offsets = dict(zip(names, np.cumsum([0] + [self.rows[n] for n in names[:-1]])))
        self.store = DeviceResidentData(names, self.rows, self.stores, offsets,
                                        inputs.slot_masks(c), "embeddings" in self.stores, dev)
        self.builder = self.store.batch_builder({s.name: s.size for s in slots})
        self.gen = torch.Generator(device=dev).manual_seed(self.seeds["step"])
        self.order = inputs.RowOrder(c, self.rows, self.seeds["rows"])
        self._check_steps()
        for _ in range(self.traffic["warmup_steps"]):
            self.run_step()
        self._sync()

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def _params(self, model) -> dict:
        return {k: v.detach().clone() for k, v in model.named_parameters()}

    def _check_steps(self):
        """The first steps, through the window's own call: their losses, each
        step's gradient as the optimizer got it (from Adam's first moment:
        g_k = (mu_k - b1 mu_k-1) / (1 - b1) is the clipped gradient, times
        the step's reported norm over the clip where it clipped), and the
        student's and teacher's change after them."""
        n = self.traffic["checked_steps"]
        p0 = self._params(self.state.student)
        names = [k for k, _ in self.state.student.named_parameters()]  # Adam's leaf order
        clip = self.config["training"].get("gradient_clip", 5.0)
        b1 = 0.9
        prev = [torch.zeros_like(p) for p in self.state.student.parameters()]
        self.checked_rows, self.prog_losses, self.prog_grads = [], [], []
        scores = []  # the student's frame scores of the first step, as its forward made them
        hook = self.state.student.register_forward_hook(
            lambda mod, args, out: scores.append(out[0].detach().float().cpu()))
        for i in range(n):
            metrics, _, _ = self.run_step(keep_rows=True)
            if i == 0:
                hook.remove()
                self.prog_scores = scores[0]
            self.prog_losses.append(float(metrics["loss"]))
            mu = [m.detach().clone() for m in self.state.opt_state["mu"]]
            unclip = max(1.0, float(metrics["grad_norm"]) / clip)
            self.prog_grads.append(leaf_norms({k: (m - b1 * q) * (unclip / (1 - b1))
                                               for k, m, q in zip(names, mu, prev)}))
            prev = mu
        self.prog_change = leaf_norms({k: v - p0[k] for k, v in
                                       self._params(self.state.student).items()})
        self.prog_teacher = leaf_norms({k: v - p0[k] for k, v in
                                        self._params(self.state.teacher).items()})

    # ------------------------------------------------------------ the timed path
    def run_step(self, keep_rows: bool = False):
        """One step: rows -> device indices -> the store's gather -> the
        train step -> one scalar fetch. Returns (metrics, the fetched
        scalar, the host seconds of the step call)."""
        rows = self.order.next()
        if keep_rows:
            self.checked_rows.append(rows)
        with span("gather"):
            idx = self.store.index_to_device(self.store.flat_index(rows))
            if self.fault == "half_batch":  # each slot's second half repeats its first
                idx = self._halve(idx)
            batch = self.builder(self.stores, idx)
        t1 = time.perf_counter()
        with span("step"):
            if self.fault == "state_unchanged":
                keep = [p.detach().clone() for p in self._leaves()]
            metrics = self.train_step(self.state, batch, self.gen)
            if self.fault == "state_unchanged":
                with torch.no_grad():
                    for p, k in zip(self._leaves(), keep):
                        p.copy_(k)
            if self.fault == "loss_altered":
                metrics = {**metrics, "loss": metrics["loss"] * 1.05}
        t2 = time.perf_counter()
        with span("fetch"):
            value = float(next(iter(metrics.values())))
        return metrics, value, t2 - t1

    def _leaves(self):
        return [*self.state.student.parameters(), *self.state.teacher.parameters()]

    def _halve(self, idx):
        out, o = idx.clone(), 0
        for s in self.config["slots"]:
            h = s["size"] // 2
            out[o + s["size"] - h:o + s["size"]] = idx[o:o + h]
            o += s["size"]
        return out

    def window(self, seconds: float) -> dict:
        """Steps until `seconds` have passed; the window ends with the step
        that crosses it."""
        times, issue, failed = [], [], 0
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        t_start = time.perf_counter()
        while True:
            t0 = time.perf_counter()
            _, value, host = self.run_step()
            t3 = time.perf_counter()
            times.append(t3 - t0)
            issue.append(host)
            failed += not np.isfinite(value)
            if t3 - t_start >= seconds:
                break
        window_s = t3 - t_start
        peak = torch.cuda.max_memory_allocated() if self.device.type == "cuda" else 0
        return {"units": len(times), "window_s": window_s, "step_s": times, "issue_s": issue,
                "clips": len(times) * self.clips, "failed": failed, "peak_bytes": peak}

    def end_to_end(self, win: dict, setup_s: float, trace=None) -> dict:
        """This kind's end-to-end values of a window and of the profiled
        block after it, where there is one (run.py keeps those that
        BENCHMARK.json gives the cell). `train_device_ms`: the device's busy
        milliseconds a step, kernels and copies merged where they overlap."""
        busy = trace.busy_s() if trace is not None and trace.device else None
        return {"setup_s": setup_s, "peak_mem_gib": win["peak_bytes"] / 2**30,
                "train_clips_per_s": win["clips"] / win["window_s"],
                "train_step_ms_p95": float(np.percentile(np.asarray(win["step_s"]) * 1e3, 95)),
                "train_device_ms": None if busy is None else 1e3 * busy / trace.units}

    def trace_units(self) -> int:
        return self.traffic["trace_steps"]

    def run_unit(self):
        self.run_step()

    def free(self):
        for name in ("state", "train_step", "stores", "store", "builder"):
            setattr(self, name, None)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------ the check
    def reference_batches(self) -> list[dict]:
        """The checked steps' batches, made again from the data seed."""
        c, dev = self.config, self.device
        data = inputs.make_clips(c, sum(self.rows.values()), self.seeds["data"], dev)
        masks = inputs.slot_masks(c)
        offs = np.cumsum([0] + [self.rows[s["name"]] for s in c["slots"]])
        out = []
        for rows in self.checked_rows:
            idx = torch.as_tensor(np.concatenate(
                [rows[s["name"]] + offs[i] for i, s in enumerate(c["slots"])]), device=dev)
            cm = np.concatenate([np.repeat(masks[s["name"]][None], s["size"], 0)
                                 for s in c["slots"]])
            out.append({"audio": data["audio"][idx].float() / 32768.0,
                        "labels": data["labels"][idx],
                        "embeddings": data["embeddings"][idx] if "embeddings" in data else None,
                        "class_mask": torch.as_tensor(cm, device=dev)})
        return out

    def program_result(self) -> dict:
        return {"losses": self.prog_losses, "grads": self.prog_grads, "scores": self.prog_scores,
                "change": self.prog_change, "teacher": self.prog_teacher}

    def reference_result(self, q=exact) -> dict:
        """The reference's checked steps from the same seeded weights, rows
        and generator seed, at precision `q`."""
        with fp32_math():
            ref = MeanTeacherReference(self.weights, self.config, self.seeds["step"],
                                       self.device, q)
            losses = [ref.step(b)["loss"] for b in self.reference_batches()]
        p0 = self.weights
        trained = [k for k in p0 if not is_statistic(k)]
        return {"losses": losses, "grads": ref.grad_norms, "scores": ref.first_scores,
                "change": leaf_norms({k: ref.student[k].detach() - p0[k] for k in trained}),
                "teacher": leaf_norms({k: ref.teacher[k] - p0[k] for k in trained})}

    def check(self, q=exact) -> dict:
        return compare(self.program_result(), self.reference_result(q))


def compare(got: dict, ref: dict) -> dict:
    """The numbers: the worst step's relative loss gap; the mean gap of the
    student's frame scores of the first step (`forward_gap`, and its widest
    gap); the median leaf's gap of the gradient norms, each leaf's gap the
    mean over the checked steps, and the worst leaf's gap of the first
    gradient; the worst leaf's gap of the student's and of the teacher's
    change after the checked steps. The cell's file names those compared
    (PERF.md gives the readings of the others). Leaves whose reference
    gradient is under a thousandth of the median leaf's are left out of
    the changes: the conv biases before BatchNorm, whose gradient is zero
    but for rounding and which Adam moves by that rounding alone."""
    first = ref["grads"][0]
    med = float(np.median(list(first.values())))
    moved = {k for k, v in first.items() if v >= 1e-3 * med}
    loss_gap = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(got["losses"], ref["losses"]))
    g, g_at = worst_leaf_gap(got["grads"][0], first)
    steps = [leaf_gaps(p, r) for p, r in zip(got["grads"], ref["grads"])]
    per_leaf = {k: float(np.mean([s[k] for s in steps])) for k in first}
    ch, ch_at = worst_leaf_gap(got["change"], ref["change"], moved)
    te, te_at = worst_leaf_gap(got["teacher"], ref["teacher"], moved)
    diff = (got["scores"] - ref["scores"]).abs()
    return {"loss_gap": loss_gap, "grad_gap_median": float(np.median(list(per_leaf.values()))),
            "forward_gap": float(diff.mean()), "forward_gap_max": float(diff.max()),
            "change_gap": ch, "teacher_gap": te, "grad_gap": g,
            "_where": {"grad_gap": g_at, "change_gap": ch_at, "teacher_gap": te_at,
                       "losses": [got["losses"], ref["losses"]], "grad_leaves": per_leaf}}
