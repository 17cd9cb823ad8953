"""Polyphonic Sound Detection Score (PSDS) and intersection-based F1 (own
copy of desed_task_tpu/metrics/psds.py, on event tables: utils/table.py).

The psds_eval library the reference wraps in
desed_task/evaluation/evaluation_measures.py (compute_psds_from_operating_points
:198, compute_per_intersection_macro_f1 :153), implemented from the PSDS
definition (Bilen et al., ICASSP 2020).

Definitions:
  * DTC: a detection of class c is valid iff
        sum_g intersections(det, gt_c in same file) / |det| >= dtc_threshold
  * GTC: a gt of class c is a TP iff
        sum_d-intersections with DTC-valid dets / |gt| >= gtc_threshold
  * FP_c: detections of class c failing the DTC.
  * CTTC: a DTC-failing detection of class c cross-triggers class c' iff its
    intersection ratio with c' gts meets cttc_threshold.
  * TPR_c = TP_c / N_c; eFPR_c = FP_c/T_data + alpha_ct * mean_{c'!=c}
    CT_{c,c'}/T_gt(c')   (rates per hour)
  * PSD-ROC: per-class staircase support (cummax TPR over sorted eFPR) merged
    on the union grid; eTPR(e) = mean_c TPR_c(e) - alpha_st * std_c TPR_c(e);
    PSDS = (1/e_max) * integral_0^e_max max(eTPR, 0) de.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np

from ..utils import table as tbl


class PSDSEval:
    def __init__(
        self,
        ground_truth,
        metadata,  # filename/duration
        dtc_threshold: float = 0.5,
        gtc_threshold: float = 0.5,
        cttc_threshold: float | None = 0.3,
    ):
        self.dtc = dtc_threshold
        self.gtc = gtc_threshold
        self.cttc = cttc_threshold
        gt = tbl.events(ground_truth)
        self.class_names = sorted({lab for *_, lab in gt})
        self._cindex = {c: i for i, c in enumerate(self.class_names)}
        self.dataset_duration = float(np.sum(tbl.column(metadata, "duration")))
        # gt intervals grouped per (filename, class)
        self._gt: dict[tuple[str, str], np.ndarray] = {}
        self.n_gt = np.zeros(len(self.class_names), int)
        self.t_gt = np.zeros(len(self.class_names))  # total gt duration (s)
        grouped = defaultdict(list)
        for f, on, off, lab in gt:
            grouped[(f, lab)].append((on, off))
        for (f, lab), ivs in grouped.items():
            arr = np.asarray(ivs)
            self._gt[(f, lab)] = arr
            i = self._cindex[lab]
            self.n_gt[i] += len(arr)
            self.t_gt[i] += float((arr[:, 1] - arr[:, 0]).sum())
        self._gt_by_file: dict[str, list[str]] = defaultdict(list)
        for f, lab in self._gt:
            self._gt_by_file[f].append(lab)

    @staticmethod
    def _intersections(dets: np.ndarray, gts: np.ndarray) -> np.ndarray:
        """[n_det, n_gt] pairwise intersection durations."""
        lo = np.maximum(dets[:, None, 0], gts[None, :, 0])
        hi = np.minimum(dets[:, None, 1], gts[None, :, 1])
        return np.maximum(0.0, hi - lo)

    def evaluate_detections(self, detections):
        """Counts for one operating point.

        Returns (tp[c], fp[c], ct[c, c']) with ct diagonal zero.
        """
        C = len(self.class_names)
        tp = np.zeros(C, int)
        fp = np.zeros(C, int)
        ct = np.zeros((C, C), int)
        grouped = defaultdict(list)
        for f, on, off, lab in tbl.events(detections):
            grouped[(f, lab)].append((on, off))
        for (f, lab), ivs in grouped.items():
            if lab not in self._cindex:
                continue
            c = self._cindex[lab]
            dets = np.asarray(ivs)
            dur = dets[:, 1] - dets[:, 0]
            gts = self._gt.get((f, lab))
            if gts is None:
                dtc_ok = np.zeros(len(dets), bool)
            else:
                inter = self._intersections(dets, gts)  # [nd, ng]
                with np.errstate(divide="ignore", invalid="ignore"):
                    ratio = np.where(dur > 0, inter.sum(1) / dur, 0.0)
                dtc_ok = ratio >= self.dtc
                # GTC on the same-class gts using only DTC-valid detections
                gt_inter = inter[dtc_ok].sum(0)
                gt_dur = gts[:, 1] - gts[:, 0]
                gtc_ok = np.where(gt_dur > 0, gt_inter / gt_dur, 0.0) >= self.gtc
                tp[c] += int(gtc_ok.sum())
            n_fp = int((~dtc_ok).sum())
            fp[c] += n_fp
            # cross-triggers from DTC-failing detections
            if self.cttc is not None and n_fp:
                failing = dets[~dtc_ok]
                fdur = failing[:, 1] - failing[:, 0]
                for other in self._gt_by_file.get(f, ()):  # classes with gt here
                    if other == lab:
                        continue
                    ogts = self._gt[(f, other)]
                    ointer = self._intersections(failing, ogts).sum(1)
                    ratio = np.where(fdur > 0, ointer / fdur, 0.0)
                    ct[c, self._cindex[other]] += int((ratio >= self.cttc).sum())
        return tp, fp, ct

    def operating_point(self, detections, alpha_ct: float = 0.0):
        """(tpr[c], efpr[c]) for one detection table; rates per hour."""
        tp, fp, ct = self.evaluate_detections(detections)
        with np.errstate(divide="ignore", invalid="ignore"):
            tpr = np.where(self.n_gt > 0, tp / self.n_gt, 0.0)
        fpr = fp * 3600.0 / self.dataset_duration
        efpr = fpr
        if alpha_ct > 0 and self.cttc is not None:
            C = len(self.class_names)
            with np.errstate(divide="ignore", invalid="ignore"):
                ctr = np.where(self.t_gt[None, :] > 0, ct * 3600.0 / self.t_gt[None, :], 0.0)
            np.fill_diagonal(ctr, 0.0)
            # fixture-calibrated detail: the original psds_eval averages the
            # cross-trigger-rate row over ALL C classes (self pair is zero),
            # not C-1 — dividing by C-1 misses the golden PSDS2 by 5e-3.
            mean_ctr = ctr.sum(1) / max(C, 1)
            efpr = fpr + alpha_ct * mean_ctr
        return tpr, efpr

    def psd_roc(
        self,
        operating_points: list,
        alpha_ct: float = 0.0,
    ):
        """Per-class staircase ROC support over all OPs.

        Returns (grid_efpr, tpr_matrix[C, n_grid]) evaluated on the union grid.
        """
        C = len(self.class_names)
        pts = [self.operating_point(op, alpha_ct) for op in operating_points]
        tprs = np.stack([p[0] for p in pts])  # [n_op, C]
        efprs = np.stack([p[1] for p in pts])
        return psd_roc_from_points(
            [(efprs[:, c], tprs[:, c]) for c in range(C)]
        )

    def psds(
        self,
        operating_points: list,
        alpha_ct: float = 0.0,
        alpha_st: float = 0.0,
        max_efpr: float = 100.0,
    ) -> float:
        grid, tpr_grid = self.psd_roc(operating_points, alpha_ct)
        mu = tpr_grid.mean(0)
        sigma = tpr_grid.std(0)  # population std over classes
        etpr = np.maximum(mu - alpha_st * sigma, 0.0)
        return self._auc_step(grid, etpr, max_efpr) / max_efpr

    @staticmethod
    def _auc_step(x: np.ndarray, y: np.ndarray, x_max: float) -> float:
        """Left-continuous staircase area over [0, x_max]."""
        keep = x <= x_max
        x = np.concatenate([x[keep], [x_max]])
        y = np.concatenate([y[keep], [y[keep][-1] if keep.any() else 0.0]])
        return float(np.sum(np.diff(x) * y[:-1]))


def psd_roc_from_points(points: list[tuple[np.ndarray, np.ndarray]]):
    """Per-class staircase ROC support from raw (efpr, tpr) point sets.

    Each class's curve is the monotone upper support of its points (sorted by
    eFPR, cumulative-max TPR, anchored at the origin), evaluated on the union
    grid of all class eFPR values. Returns (grid, tpr_grid[C, n_grid])."""
    curves = []
    for efpr, tpr in points:
        x = np.concatenate([[0.0], efpr])
        y = np.concatenate([[0.0], tpr])
        order = np.lexsort((y, x))
        x, y = x[order], y[order]
        y = np.maximum.accumulate(y)  # monotone support
        curves.append((x, y))
    grid = np.unique(np.concatenate([c[0] for c in curves]))
    tpr_grid = np.zeros((len(curves), len(grid)))
    for c, (x, y) in enumerate(curves):
        idx = np.searchsorted(x, grid, side="right") - 1
        tpr_grid[c] = np.where(idx >= 0, y[np.maximum(idx, 0)], 0.0)
    return grid, tpr_grid


def psds_from_points(
    points: list[tuple[np.ndarray, np.ndarray]],
    alpha_st: float = 0.0,
    max_efpr: float = 100.0,
) -> float:
    """PSDS from per-class (efpr, tpr) point sets (same aggregation as
    PSDSEval.psds: mean-std effective TPR, left-step integration)."""
    grid, tpr_grid = psd_roc_from_points(points)
    mu = tpr_grid.mean(0)
    sigma = tpr_grid.std(0)
    etpr = np.maximum(mu - alpha_st * sigma, 0.0)
    return PSDSEval._auc_step(grid, etpr, max_efpr) / max_efpr


def plot_psd_roc(
    ev: "PSDSEval",
    operating_points,
    alpha_ct: float = 0.0,
    alpha_st: float = 0.0,
    max_efpr: float = 100.0,
    filename=None,
    title: str = "PSD-ROC",
):
    """Save the (effective) PSD-ROC curve like the reference
    (evaluation_measures.py:231-253, 285-303). Returns the figure (needs
    matplotlib)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    grid, tpr = ev.psd_roc(operating_points, alpha_ct)
    mu = tpr.mean(0)
    sigma = tpr.std(0)
    etpr = np.maximum(mu - alpha_st * sigma, 0.0)
    fig, ax = plt.subplots(figsize=(7, 7))
    keep = grid <= max_efpr
    ax.step(grid[keep], etpr[keep], where="post", label="eTPR (mean - a_st*std)")
    ax.step(grid[keep], mu[keep], where="post", alpha=0.5, label="mean TPR")
    for c, name in enumerate(ev.class_names):
        ax.step(grid[keep], tpr[c][keep], where="post", alpha=0.25, lw=0.7)
    ax.set_xlabel("eFPR (per hour)")
    ax.set_ylabel("eTPR")
    ax.set_xlim(0, max_efpr)
    ax.set_ylim(0, 1)
    ax.legend()
    ax.set_title(title)
    if filename is not None:
        fig.savefig(filename, dpi=120, bbox_inches="tight")
        plt.close(fig)
    return fig


def compute_psds_from_operating_points(
    prediction_dfs: dict | list,
    ground_truth,
    durations,
    dtc_threshold: float = 0.5,
    gtc_threshold: float = 0.5,
    cttc_threshold: float = 0.3,
    alpha_ct: float = 0.0,
    alpha_st: float = 0.0,
    max_efpr: float = 100.0,
) -> tuple[float, PSDSEval]:
    """API-parity wrapper (evaluation_measures.py:198-255)."""
    if isinstance(prediction_dfs, dict):
        prediction_dfs = [prediction_dfs[k] for k in sorted(prediction_dfs)]
    ev = PSDSEval(
        ground_truth,
        durations,
        dtc_threshold=dtc_threshold,
        gtc_threshold=gtc_threshold,
        cttc_threshold=cttc_threshold,
    )
    value = ev.psds(prediction_dfs, alpha_ct=alpha_ct, alpha_st=alpha_st, max_efpr=max_efpr)
    return value, ev


def compute_per_intersection_macro_f1(
    prediction_dfs,
    ground_truth,
    durations,
    dtc_threshold: float = 0.5,
    gtc_threshold: float = 0.5,
    cttc_threshold: float = 0.3,
) -> float:
    """Intersection-criterion macro F1 at a single operating point
    (evaluation_measures.py:153-197): per class F = 2TP/(2TP+FP+FN) with
    TP/FP from the DTC/GTC counting and FN = N_gt - TP."""
    if isinstance(prediction_dfs, dict) and "event_label" not in prediction_dfs:
        det = tbl.concat(prediction_dfs.values())  # {key: event table}
    else:
        det = prediction_dfs
    ev = PSDSEval(
        ground_truth,
        durations,
        dtc_threshold=dtc_threshold,
        gtc_threshold=gtc_threshold,
        cttc_threshold=cttc_threshold,
    )
    tp, fp, _ = ev.evaluate_detections(det)
    fn = ev.n_gt - tp
    denom = 2 * tp + fp + fn
    with np.errstate(divide="ignore", invalid="ignore"):
        f1 = np.where(denom > 0, 2 * tp / denom, 0.0)
    return float(f1.mean())
