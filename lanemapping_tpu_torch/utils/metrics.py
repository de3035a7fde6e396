"""Evaluation metrics: buffered coordinate F1, endpoint F1, skeleton seg F1
(a copy of `lanemapping_tpu/utils/metrics.py`).

Parity with the reference's `baseline/utils/metric_utils.py:47-64,112-166,
415-514`.  The reference's coordinate matching is a quadruple Python loop
(lane x row x lane); here it is one broadcasted [Np,Ng,S] comparison.
"""

from __future__ import annotations

from typing import Dict, Union

import numpy as np

EPS = 1e-16


def prf_from_counts(tp: int, n_pred: int, dg: int, n_gt: int):
    """(precision, recall, F1) from pooled bidirectional match counts with
    the zero-denominator guards shared by every metric family."""
    acc = tp / n_pred if n_pred else 0.0
    recall = dg / n_gt if n_gt else 0.0
    f1 = 2 * acc * recall / (acc + recall) if (acc + recall) > 0 else 0.0
    return acc, recall, f1


def _buffered_hits(src: np.ndarray, ref: np.ndarray, buffer_px: float,
                   img_w: int):
    """For every positive vertex in ``src`` [N,S]: does any ``ref`` lane have
    a vertex on the same row strictly inside (col-buf, col+buf)?  Bounds are
    clamped to [0, W-1] and exclusive (reference `:138-163`)."""
    lo = np.maximum(0.0, src - buffer_px)          # [N,S]
    hi = np.minimum(img_w - 1.0, src + buffer_px)
    r = ref[None, :, :]                            # [1,M,S]
    hit = (r > lo[:, None, :]) & (r < hi[:, None, :])
    hit = hit.any(axis=1)                          # [N,S]
    pos = src > 0
    return int(np.sum(hit & pos)), int(np.sum(pos))


def cal_coor_measures(arr_label: np.ndarray, arr_pred: np.ndarray,
                      buffer_px: float = 10, img_size: int = 1152) -> Dict:
    """Two-direction buffered point F1 on row-anchor coordinates
    (reference `cal_coor_measures:47-64` + `metric2:112-166`)."""
    arr_label = np.asarray(arr_label, dtype=np.float64)
    arr_pred = np.asarray(arr_pred, dtype=np.float64)
    tp, n_pred = _buffered_hits(arr_pred, arr_label, buffer_px, img_size)
    dg, n_gt = _buffered_hits(arr_label, arr_pred, buffer_px, img_size)
    acc = tp / (n_pred + EPS)
    recall = dg / (n_gt + EPS)
    f1 = 2.0 * acc * recall / (acc + recall + EPS)
    return {"acc": acc, "recall": recall, "f1": f1, "tp": tp,
            "n_pred": n_pred, "dg": dg, "n_gt": n_gt}


def _kdtree_prf(pred_pts: np.ndarray, gt_pts: np.ndarray,
                thre: float) -> Dict:
    """Bidirectional nearest-neighbour P/R/F1 within ``thre``
    (reference `:432-442,494-513`)."""
    from scipy.spatial import cKDTree

    tp = dg = n_pred = n_gt = 0
    if len(gt_pts) and len(pred_pts):
        gt_tree = cKDTree(gt_pts)
        pred_tree = cKDTree(pred_pts)
        d_gt, _ = pred_tree.query(gt_pts, k=1)   # gt covered by pred
        d_pr, _ = gt_tree.query(pred_pts, k=1)   # pred matched to gt
        tp = int(np.sum(d_pr < thre))
        n_pred = len(pred_pts)
        dg = int(np.sum(d_gt < thre))
        n_gt = len(gt_pts)
    elif len(gt_pts):
        n_gt = len(gt_pts)
    elif len(pred_pts):
        n_pred = len(pred_pts)
    acc, recall, f1 = prf_from_counts(tp, n_pred, dg, n_gt)
    return {"acc": acc, "recall": recall, "f1": f1, "tp": tp,
            "n_pred": n_pred, "dg": dg, "n_gt": n_gt}


def eval_metric_line_segmentor(seg_result: np.ndarray, mask: np.ndarray,
                               bi_seg: bool = True, semantics: int = 2,
                               buffer_px: float = 10) -> Dict:
    """Skeletonised segmentation F1 (reference `:415-481`)."""
    from .skeleton import skeletonize

    if bi_seg:
        skel = skeletonize((seg_result > 0).astype(np.uint8))
        return _kdtree_prf(np.argwhere(skel != 0), np.argwhere(mask != 0),
                           buffer_px)
    agg = {"tp": 0, "n_pred": 0, "dg": 0, "n_gt": 0}
    for sid in range(1, semantics + 1):
        skel = skeletonize((seg_result == sid).astype(np.uint8))
        m = _kdtree_prf(np.argwhere(skel != 0), np.argwhere(mask == sid),
                        buffer_px)
        for k in agg:
            agg[k] += m[k]
    acc, recall, f1 = prf_from_counts(**agg)
    return {"acc": acc, "recall": recall, "f1": f1, **agg}


def _neighborhood_match(a: np.ndarray, center: np.ndarray) -> np.ndarray:
    """any 3x3 neighbour of ``a`` equals ``center`` (interior pixels only)."""
    h, w = a.shape
    out = np.zeros((h, w), bool)
    inner = np.zeros((h, w), bool)
    inner[1:h - 1, 1:w - 1] = True
    for dr in (-1, 0, 1):
        for dc in (-1, 0, 1):
            shifted = np.roll(np.roll(a, dr, 0), dc, 1)
            out |= shifted == center
    return out & inner


def grid_measures(arr_label: np.ndarray, arr_pred: np.ndarray,
                  occupied: float = 1.0) -> Dict:
    """Legacy 144x144 grid metrics with a 3x3 matching buffer
    (reference `calc_measures_conf:178-241`), vectorised."""
    label = np.asarray(arr_label)
    pred = np.asarray(arr_pred)
    pred_enh = _neighborhood_match(pred, label)
    label_enh = _neighborhood_match(label, pred)
    inner = np.zeros_like(pred_enh)
    inner[1:-1, 1:-1] = True  # reference loops rows/cols 1..142
    is_lb = (label == occupied) & inner
    is_pr = (pred == occupied) & inner
    tp = int(np.sum(is_lb & pred_enh))
    fn = int(np.sum(is_lb & ~pred_enh))
    fp = int(np.sum(is_pr & ~label_enh))
    tn = label.size - tp - fp - fn
    acc = (tp + tn) / (tp + tn + fp + fn + EPS)
    precision = tp / (tp + fp + EPS)
    recall = tp / (tp + fn + EPS)
    f1 = 2 * tp / (2 * tp + fp + fn + EPS)
    return {"acc": acc, "precision": precision, "recall": recall, "f1": f1,
            "tp": tp, "fp": fp, "fn": fn}


def eval_metric_endp_detector(endp_pred: Union[np.ndarray, list],
                              endp_gt: np.ndarray, r_thre: float = 10) -> Dict:
    """Endpoint F1 (reference `:483-514`).  ``endp_pred`` is either an [N,2]
    coordinate array or a heatmap thresholded at 0.99."""
    endp_pred = np.asarray(endp_pred)
    if endp_pred.ndim == 2 and endp_pred.shape[-1] == 2:
        pred_pts = endp_pred
    else:
        pred_pts = np.argwhere(endp_pred > 0.99)
    gt_pts = np.argwhere(np.asarray(endp_gt) > 0.99)
    return _kdtree_prf(pred_pts, gt_pts, r_thre)
