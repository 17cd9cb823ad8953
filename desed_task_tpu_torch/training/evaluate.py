"""Validation and test harnesses: batched prediction + the DCASE metric battery
(counterpart of desed_task_tpu/training/evaluate.py).

    validation: weak multilabel macro-F1 @0.5 + the DESED synth metric
                (intersection F1, or collar F1; optionally a PSDS1 and collar
                F1 trajectory) + the MAESTRO segment metric (best F1 /
                mpAUC / mAUC); obj_metric = their sum
                (sed_trainer_pretrained.py:742-776)
    test:       PSDS1 + PSDS2 over 50 thresholds, their sed_scores_eval-style
                twins on the score curves, intersection and collar F1, and
                MAESTRO's overlap-added segment metrics.

`predict_fn` is `training.mean_teacher.make_predict_step()`: it takes a
module where the JAX package's takes (params, stats), so `SEDValidator` and
`run_test` take a `MeanTeacherState` and read `state.student`,
`state.teacher` and `state.scaler`.

A `DeviceEvalCache` is predicted by one loop over its resident batches,
with the class-wise median filter on the card and one fetch of the stacked
scores at the end: no host synchronisation inside the loop (the JAX
package's `lax.scan` in one dispatch). A cache row-sharded over a mesh's
data axis (DeviceEvalCache.upload(mesh=...)) runs each rank's own batches
through the same loop, then gathers the scores on the host, in global row
order, to the axis's first rank over the axis's gloo group (the scores go
to the host anyway, and gloo's collectives on CUDA tensors are fewer than
NCCL's), as the JAX package's one fetch of the sharded scan does
(evaluate.py:123-151). Only that rank decodes and computes metrics:
`predict_dataset` and `run_test` give None on the others, and
`SEDValidator` hands every rank the first rank's objective and scalars.
Event and score tables need no pandas
(utils/table.py); only `run_test(save_dir=...)` imports matplotlib, for the
PSD-ROC plots, and writes the rest without it.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..data.batcher import collate
from ..data.device_cache import DeviceEvalCache
from ..inference.decode import batched_decode_preds
from ..inference.io import write_predictions
from ..inference.maestro import get_segment_scores_and_overlap_add, merge_maestro_ground_truth
from ..labels.encoder import ManyHotEncoder
from ..metrics.event_based import event_based_metrics
from ..metrics.psds import compute_per_intersection_macro_f1, compute_psds_from_operating_points
from ..metrics.scores import compute_psds_from_scores
from ..metrics.segments import auroc, best_fscore, segment_scores_and_labels
from ..obs.profiling import span
from ..ops.median import classwise_median_filter
from ..utils import table as tbl


def multilabel_f1_macro(probs: np.ndarray, targets: np.ndarray, threshold: float = 0.5) -> float:
    """torchmetrics MultilabelF1Score(average='macro') semantics."""
    preds = np.asarray(probs) >= threshold
    t = np.asarray(targets) > 0.5
    tp = (preds & t).sum(0)
    fp = (preds & ~t).sum(0)
    fn = (~preds & t).sum(0)
    denom = 2 * tp + fp + fn
    f1 = np.where(denom > 0, 2 * tp / np.maximum(denom, 1), 0.0)
    return float(f1.mean())


def _predict_cache_all(predict_fn, model, cache: DeviceEvalCache, scaler, median_filter,
                       want_raw: bool):
    """The forward of a whole DeviceEvalCache: a loop over its resident
    batches that leaves everything on the device (the per-class median
    filter included), then one copy of the stacked scores to the host.

    Returns (strong | None, post | None, weak) as numpy, cut to len(cache);
    post is None when the filter cannot run on the device (a callable
    filter stays on the host), strong is None unless wanted or needed. On
    a sharded cache: the gathered scores on the data axis's first rank,
    None on the others."""
    on_device_median = isinstance(median_filter, (list, tuple, np.ndarray))
    med = tuple(int(f) for f in median_filter) if on_device_median else None
    fetch_raw = want_raw or not on_device_median
    with span("eval"):
        outs = []  # per batch: ([strong], [post], weak)
        for start in range(0, cache.rows, cache.batch_size):
            audio, emb = cache.batch(start)
            strong, weak = predict_fn(model, audio, embeddings=emb, scaler=scaler)
            row = [strong] if fetch_raw else []
            if med is not None:
                with span("eval.median"):
                    row.append(classwise_median_filter(strong, med, class_axis=-2))
            outs.append(row + [weak])
        with span("eval.copy"):  # one device-to-host copy of everything
            parts = [torch.cat([o[k] for o in outs]).float() for k in range(len(outs[0]))]
            flat = torch.cat([p.flatten() for p in parts]).cpu()
        shards = [flat]
        if cache.mesh is not None:
            group = cache.mesh.cpu_groups[cache.mesh_axis]
            root = cache.mesh.root(cache.mesh_axis)
            shards = ([torch.empty_like(flat) for _ in range(dist.get_world_size(group))]
                      if dist.get_rank() == root else None)
            dist.gather(flat, shards, dst=root, group=group)
            if shards is None:
                return None
        host, at = [], 0
        for p in parts:  # each part: the shards' rows in rank order, global row order
            rows = [s[at : at + p.numel()].numpy().reshape(p.shape) for s in shards]
            host.append(np.concatenate(rows)[: cache.n])
            at += p.numel()
        strong_np = host[0] if fetch_raw else None
        post_np = host[-2] if med is not None else None
        return strong_np, post_np, host[-1]


def iterate_batches(dataset, batch_size: int):
    items = []
    for i in range(len(dataset)):
        items.append(dataset[i])
        if len(items) == batch_size:
            yield collate(items)
            items = []
    if items:
        yield collate(items)


def _pad_rows(a: np.ndarray, n: int) -> np.ndarray:
    """Zero rows appended up to n rows."""
    if len(a) == n:
        return a
    return np.concatenate([a, np.zeros((n - len(a), *a.shape[1:]), a.dtype)])


def predict_dataset(
    predict_fn: Callable,
    model,
    dataset,
    encoder: ManyHotEncoder,
    batch_size: int = 24,
    thresholds=(0.5,),
    median_filter=None,
    scaler=None,
    want_raw: bool = True,
    want_post: bool = True,
    want_events: bool = True,
    as_arrays: bool = False,
):
    """Forward a dataset through `model`, decode. Returns (scores_raw,
    scores_post, event tables {th: table}, weak_probs [N, C],
    weak_targets [N, C]); outputs gated off by want_* come back empty.

    `dataset` is a sequence of item dicts (each batch, the last one
    zero-padded to `batch_size`, goes to the model's device) or a
    DeviceEvalCache (one loop over its resident batches, one fetch). None
    on a rank of a sharded cache's mesh other than the one that gathers."""
    scores_raw_all, scores_post_all = {}, {}
    tables_all = {th: [] for th in thresholds}
    weak_probs, weak_targets = [], []
    decode_ths = thresholds if want_events else ()

    def decode(strong, filenames, median, post=None):
        if want_raw or want_post or want_events:
            raw, post, tables = batched_decode_preds(
                strong, filenames, encoder, thresholds=decode_ths, median_filter=median,
                want_raw=want_raw, want_post=want_post, as_arrays=as_arrays, post_preds=post)
            scores_raw_all.update(raw)
            scores_post_all.update(post)
            for th in decode_ths:
                tables_all[th].append(tables[th])

    if isinstance(dataset, DeviceEvalCache):
        got = _predict_cache_all(predict_fn, model, dataset, scaler, median_filter,
                                 want_raw=want_raw)
        if got is None:
            return None
        strong_np, post_np, weak_np = got
        decode(post_np if strong_np is None else strong_np, dataset.filenames,
               None if post_np is not None else median_filter, post_np)
        weak_probs.append(weak_np)
        weak_targets.append((dataset.labels.sum(-1) > 0).astype(np.float32))
    else:
        device = next(model.parameters()).device
        for batch in iterate_batches(dataset, batch_size):
            n_real = len(batch["audio"])
            audio = torch.as_tensor(_pad_rows(np.asarray(batch["audio"]), batch_size),
                                    device=device)
            emb = None
            if "embeddings" in batch:
                emb = torch.as_tensor(_pad_rows(np.asarray(batch["embeddings"]), batch_size),
                                      device=device)
            strong, weak = predict_fn(model, audio, embeddings=emb, scaler=scaler)
            strong = strong.float().cpu().numpy()[:n_real]
            weak = weak.float().cpu().numpy()[:n_real]
            filenames = batch.get("filename",
                                  [f"clip_{len(weak_probs)}_{i}" for i in range(n_real)])
            decode(strong, filenames, median_filter)
            weak_probs.append(weak)
            weak_targets.append((np.asarray(batch["labels"]).sum(-1) > 0).astype(np.float32))
    return _assemble_predictions(scores_raw_all, scores_post_all, tables_all, weak_probs,
                                 weak_targets)


def _assemble_predictions(scores_raw_all, scores_post_all, tables_all, weak_probs,
                          weak_targets):
    return (
        scores_raw_all,
        scores_post_all,
        {th: tbl.concat(v) for th, v in tables_all.items()},
        np.concatenate(weak_probs) if weak_probs else np.zeros((0, 1)),
        np.concatenate(weak_targets) if weak_targets else np.zeros((0, 1)),
    )


def _maestro_metrics(predict_fn, model, maestro_set, maestro_gt, classes, encoder,
                     batch_size, scaler):
    """MAESTRO's windowed clips overlap-added into file-level 1-s segment
    scores: (segment scores, gt tuples, durations, flattened segments); None
    where predict_dataset gives None."""
    got = predict_dataset(
        predict_fn, model, maestro_set, encoder, batch_size, thresholds=(0.5,), scaler=scaler,
        want_raw=False, want_events=False, as_arrays=True)
    if got is None:
        return None
    post = got[1]
    gt = merge_maestro_ground_truth(maestro_gt)
    durations = {fid: max(off for _, off, _ in evs) if evs else 1.0 for fid, evs in gt.items()}
    seg_scores = get_segment_scores_and_overlap_add(post, durations, classes, as_arrays=True)
    seg_scores = {k: v for k, v in seg_scores.items() if k in gt}
    gt_tuples = {k: [(on, off, c) for on, off, c in gt[k]] for k in seg_scores}
    pre = segment_scores_and_labels(seg_scores, gt_tuples, durations, 1.0, classes)
    return seg_scores, gt_tuples, durations, pre


class SEDValidator:
    """Validation callback: `validator(state, epoch) -> (obj, scalars)`.

    weak_set: clip-level F1; synth_set with synth_gt / synth_dur (event and
    duration tables): the synth metric; maestro_set with maestro_gt
    ({clip_id: [(onset, offset, class)]}): the MAESTRO segment metric. Each
    set is a sequence of item dicts or a DeviceEvalCache.
    """

    def __init__(
        self,
        predict_fn,
        encoder: ManyHotEncoder,
        weak_set=None,
        synth_set=None,
        synth_gt=None,
        synth_dur=None,
        maestro_set=None,
        maestro_gt: Optional[dict] = None,
        maestro_classes: Optional[list] = None,
        batch_size: int = 24,
        median_filter=None,
        obj_metric_synth_type: str = "intersection",
        obj_metric_maestro_type: str = "fmo",
        desed_classes: Optional[list] = None,
        use_teacher: bool = False,
        log_teacher: bool = True,
        trajectory_psds: int = 0,
    ):
        self.predict_fn = predict_fn
        self.encoder = encoder
        self.weak_set = weak_set
        self.synth_set = synth_set
        self.synth_gt = synth_gt
        self.synth_dur = synth_dur
        self.maestro_set = maestro_set
        self.maestro_gt = maestro_gt
        self.maestro_classes = maestro_classes
        self.batch_size = batch_size
        self.median_filter = median_filter
        self.obj_metric_synth_type = obj_metric_synth_type
        self.obj_metric_maestro_type = obj_metric_maestro_type
        self.desed_classes = desed_classes or encoder.labels
        self.use_teacher = use_teacher
        self.log_teacher = log_teacher
        # > 0: also a PSDS1 over this many operating points and a collar F1
        # on the synth set at every validation (student only)
        self.trajectory_psds = trajectory_psds

    def _evaluate_one(self, state, model, tag: str):
        """Full metric pass for one model (student or teacher); on a rank
        whose sharded predictions went to another, (0.0, {})."""
        scalars = {}
        obj = 0.0
        run = lambda ds, **kw: predict_dataset(self.predict_fn, model, ds, self.encoder,
                                               self.batch_size, scaler=state.scaler, **kw)

        weak = synth = maestro = None
        if self.weak_set is not None:
            weak = run(self.weak_set, thresholds=(0.5,), want_raw=False, want_post=False,
                       want_events=False)
        if weak is not None:
            _, _, _, probs, targets = weak
            weak_f1 = multilabel_f1_macro(probs, targets)
            scalars[f"val/weak/{tag}/macro_F1"] = weak_f1
            obj += weak_f1

        traj_ths = ()
        if self.trajectory_psds and tag == "student":
            n = self.trajectory_psds
            traj_ths = tuple(np.arange(1 / (n * 2), 1, 1 / n))
        if self.synth_set is not None and self.synth_gt is not None:
            synth = run(self.synth_set, thresholds=traj_ths + (0.5,),
                        median_filter=self.median_filter, want_raw=False, want_post=False)
        if synth is not None:
            tables = synth[2]
            inter_f1 = compute_per_intersection_macro_f1(tables[0.5], self.synth_gt,
                                                         self.synth_dur)
            scalars[f"val/synth/{tag}/intersection_f1_macro"] = inter_f1
            if traj_ths:
                psds1, _ = compute_psds_from_operating_points(
                    [tables[th] for th in traj_ths], self.synth_gt, self.synth_dur,
                    dtc_threshold=0.7, gtc_threshold=0.7, alpha_ct=0, alpha_st=1)
                collar = event_based_metrics(self.synth_gt, tables[0.5], self.desed_classes)
                scalars[f"val/synth/{tag}/psds1"] = psds1
                scalars[f"val/synth/{tag}/event_f1_macro"] = collar["macro_f_measure"]
            if self.obj_metric_synth_type == "intersection":
                obj += inter_f1
            elif self.obj_metric_synth_type == "collar":
                res = event_based_metrics(self.synth_gt, tables[0.5], self.desed_classes)
                scalars[f"val/synth/{tag}/event_f1_macro"] = res["macro_f_measure"]
                obj += res["macro_f_measure"]
            else:
                raise NotImplementedError(self.obj_metric_synth_type)

        classes = self.maestro_classes or self.encoder.labels
        if self.maestro_set is not None and self.maestro_gt is not None:
            maestro = _maestro_metrics(self.predict_fn, model, self.maestro_set,
                                       self.maestro_gt, classes, self.encoder, self.batch_size,
                                       state.scaler)
        if maestro is not None:
            seg, gt, dur, pre = maestro
            if self.obj_metric_maestro_type in ("fmo", "mpauc"):
                res, _ = best_fscore(seg, gt, dur, 1.0, classes, precomputed=pre)
                scalars[f"val/maestro/{tag}/segment_f1_best"] = res["macro_average"]
                maestro_metric = res["macro_average"]
                res_p, _ = auroc(seg, gt, dur, 1.0, 0.1, classes, precomputed=pre)
                scalars[f"val/maestro/{tag}/segment_mpauc"] = res_p["mean"]
            elif self.obj_metric_maestro_type == "mauc":
                res, _ = auroc(seg, gt, dur, 1.0, None, classes, precomputed=pre)
                maestro_metric = res["mean"]
                scalars[f"val/maestro/{tag}/segment_mauc"] = maestro_metric
            else:
                raise NotImplementedError(self.obj_metric_maestro_type)
            obj += maestro_metric

        return obj, scalars

    def __call__(self, state, epoch: int):
        obj, scalars = self._evaluate_one(state, state.student, "student")
        if self.log_teacher:
            t_obj, t_scalars = self._evaluate_one(state, state.teacher, "teacher")
            scalars.update(t_scalars)
            scalars["val/teacher/obj_metric"] = t_obj
            if self.use_teacher:
                obj = t_obj
        sharded = _sharded_mesh(self.weak_set, self.synth_set, self.maestro_set)
        if sharded is not None:  # the gathering rank's metrics, to every rank
            mesh, axis = sharded
            got = [obj, scalars]
            dist.broadcast_object_list(got, src=mesh.root(axis), group=mesh.cpu_groups[axis])
            obj, scalars = got
        return obj, scalars


def _sharded_mesh(*sets):
    """(mesh, axis) of the first sharded DeviceEvalCache among `sets`, or None."""
    for ds in sets:
        if isinstance(ds, DeviceEvalCache) and ds.mesh is not None:
            return ds.mesh, ds.mesh_axis
    return None


def run_test(
    predict_fn,
    state,
    test_set,
    encoder: ManyHotEncoder,
    test_gt,
    test_dur,
    batch_size: int = 24,
    n_thresholds: int = 50,
    median_filter=None,
    use_teacher: bool = False,
    desed_classes: Optional[list] = None,
    save_dir=None,
    maestro_set=None,
    maestro_gt: Optional[dict] = None,
    maestro_classes: Optional[list] = None,
) -> dict:
    """The DESED test battery at `n_thresholds` operating points and 0.5, and
    optionally MAESTRO's overlap-added segment metrics (on_test_epoch_end
    :1192-1222). test_gt, test_dur: event and duration tables.
    `scores_postprocessed` comes back as ScoreCurve tuples; with save_dir,
    the per-threshold prediction files and, where matplotlib can be
    imported, the two PSD-ROC plots (else one printed line says that they
    were not written, and why). None on a rank of a sharded test cache's
    mesh other than the one that gathers (its scores went there), which
    alone computes the metrics and writes the files."""
    model = state.teacher if use_teacher else state.student
    thresholds = list(np.arange(1 / (n_thresholds * 2), 1, 1 / n_thresholds)) + [0.5]
    got = predict_dataset(
        predict_fn, model, test_set, encoder, batch_size, thresholds=thresholds,
        median_filter=median_filter, scaler=state.scaler, want_raw=False, as_arrays=True)
    maestro = None
    if maestro_set is not None and maestro_gt is not None:
        m_classes = maestro_classes or encoder.labels
        maestro = _maestro_metrics(predict_fn, model, maestro_set, maestro_gt, m_classes,
                                   encoder, batch_size, state.scaler)
    if got is None:
        return None
    _, post, tables, _, _ = got
    ops = [tables[th] for th in thresholds[:-1]]
    psds1, ev1 = compute_psds_from_operating_points(
        ops, test_gt, test_dur, dtc_threshold=0.7, gtc_threshold=0.7, alpha_ct=0, alpha_st=1)
    psds2, ev2 = compute_psds_from_operating_points(
        ops, test_gt, test_dur, dtc_threshold=0.1, gtc_threshold=0.1, cttc_threshold=0.3,
        alpha_ct=0.5, alpha_st=1)
    if save_dir is not None:
        d = Path(save_dir)
        d.mkdir(parents=True, exist_ok=True)
        try:
            import matplotlib  # noqa: F401
        except ImportError as e:
            print(f"run_test: the two PSD-ROC plots were not written to {d}: matplotlib "
                  f"cannot be imported ({e})", flush=True)
        else:
            from ..metrics.psds import plot_psd_roc

            plot_psd_roc(ev1, ops, 0, 1, filename=d / "PSDS_scenario1_roc.png",
                         title=f"PSDS scenario 1 = {psds1:.4f}")
            plot_psd_roc(ev2, ops, 0.5, 1, filename=d / "PSDS_scenario2_roc.png",
                         title=f"PSDS scenario 2 = {psds2:.4f}")
        # per-threshold prediction files, reference layout
        # (evaluation_measures.py:232-245)
        for dtc, gtc, cttc in ((0.7, 0.7, 0.3), (0.1, 0.1, 0.3)):
            write_predictions({th: tables[th] for th in thresholds[:-1]},
                              d / f"predictions_dtc{dtc}_gtc{gtc}_cttc{cttc}")
    # threshold-free "sed scores" variants on the postprocessed score curves
    psds1_sed = compute_psds_from_scores(post, test_gt, test_dur, dtc_threshold=0.7,
                                         gtc_threshold=0.7, alpha_ct=0, alpha_st=1)
    psds2_sed = compute_psds_from_scores(post, test_gt, test_dur, dtc_threshold=0.1,
                                         gtc_threshold=0.1, cttc_threshold=0.3, alpha_ct=0.5,
                                         alpha_st=1)
    inter_f1 = compute_per_intersection_macro_f1(tables[0.5], test_gt, test_dur)
    classes = desed_classes or sorted(tbl.labels(test_gt))
    collar = event_based_metrics(test_gt, tables[0.5], classes)
    results = {
        "psds1": psds1,
        "psds2": psds2,
        "psds1_sed_scores_eval": psds1_sed,
        "psds2_sed_scores_eval": psds2_sed,
        "intersection_f1_macro": inter_f1,
        "event_f1_macro": collar["macro_f_measure"],
        "scores_postprocessed": post,
        "prediction_dfs": tables,
    }
    if maestro is not None:
        seg, gt, dur, pre = maestro
        mauc, _ = auroc(seg, gt, dur, 1.0, None, m_classes, precomputed=pre)
        mpauc, _ = auroc(seg, gt, dur, 1.0, 0.1, m_classes, precomputed=pre)
        bf, _ = best_fscore(seg, gt, dur, 1.0, m_classes, precomputed=pre)
        results["maestro_segment_mauc"] = mauc["mean"]
        results["maestro_segment_mpauc"] = mpauc["mean"]
        results["maestro_segment_f1_best"] = bf["macro_average"]
    return results
