"""Offline label generation: dense annotation seqs -> sparse training labels
(a copy of `lanemapping_tpu/data/label_gen.py`).

Capability parity with the reference generator
(reference `data/convert_data.py:72-396`): per-vertex orientation
binning into 11 classes, top-K lane selection inside a column range,
rasterised semantic/instance/orientation maps, Gaussian endpoint heatmaps,
and the sparse-seq JSON sidecar.  Implementation is vectorised NumPy with a
Bresenham-style rasteriser (no cv2 dependency on the hot path — the same
routine later feeds the XLA re-render).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Sequence, Tuple

import numpy as np

# orientation class edges over the normalised column component of the
# direction vector (reference `convert_data.py:81-102`): 11 classes,
# 0 = steep left ... 5 = near-vertical ... 10 = steep right.
_ORIENT_EDGES = np.array(
    [-0.92, -0.86, -0.78, -0.6, -0.25, 0.25, 0.6, 0.78, 0.86, 0.92])


class NpEncoder(json.JSONEncoder):
    def default(self, obj):
        if isinstance(obj, np.integer):
            return int(obj)
        if isinstance(obj, np.floating):
            return float(obj)
        if isinstance(obj, np.ndarray):
            return obj.tolist()
        return super().default(obj)


def orientation_classes(seq: np.ndarray) -> np.ndarray:
    """Per-segment orientation class for a [V,2] (row,col) polyline."""
    d = np.diff(seq, axis=0).astype(np.float64)
    norm = np.sqrt((d ** 2).sum(-1))
    norm = np.where(norm == 0, 1.0, norm)
    c = d[:, 1] / norm
    cls = np.digitize(c, _ORIENT_EDGES)  # 0..10
    out = np.zeros(seq.shape[0], dtype=np.int64)
    out[:-1] = cls
    return out


def rasterize_segments(img: np.ndarray, p0: np.ndarray, p1: np.ndarray,
                       values: np.ndarray) -> None:
    """Draw 1-px line segments into ``img`` in place.

    ``p0``/``p1`` are [N,2] (row,col) int endpoints; ``values`` [N].
    Dense-sampling rasterisation equivalent to ``cv2.line`` thickness 1
    (reference `convert_data.py:350-356`).
    """
    h, w = img.shape
    for a, b, v in zip(p0, p1, values):
        n = int(max(abs(b[0] - a[0]), abs(b[1] - a[1]))) + 1
        t = np.linspace(0.0, 1.0, n)
        rr = np.rint(a[0] + (b[0] - a[0]) * t).astype(np.int64)
        cc = np.rint(a[1] + (b[1] - a[1]) * t).astype(np.int64)
        keep = (rr >= 0) & (rr < h) & (cc >= 0) & (cc < w)
        img[rr[keep], cc[keep]] = v


def rasterize_polyline(img: np.ndarray, seq: np.ndarray,
                       values) -> None:
    """Draw a [V,2] (row,col) polyline; ``values`` scalar or per-segment."""
    seq = np.asarray(seq)
    if len(seq) < 2:
        return
    vals = np.broadcast_to(np.asarray(values), (len(seq) - 1,))
    rasterize_segments(img, seq[:-1], seq[1:], vals)


def gaussian_peak(h: int, w: int, r: int, c: int, sigma: float) -> np.ndarray:
    yy = np.arange(h)[:, None] - r
    xx = np.arange(w)[None, :] - c
    return np.exp(-(yy ** 2 + xx ** 2) / (2.0 * sigma ** 2)).astype(np.float32)


def endpoint_heatmap(init_pts: np.ndarray, end_pts: np.ndarray,
                     img_h: int = 1152, img_w: int = 1152,
                     sigma: float = 2.0, clip_width: int = 20) -> np.ndarray:
    """Max-merged Gaussian endpoint heatmap (reference
    `convert_data.py:248-317`, `train_sample_utils.py:19-81`): peaks only for
    endpoints at least ``clip_width`` px inside the border, exact centre
    pinned to 1."""
    EPS = 1e-3
    out = np.zeros((img_h, img_w), dtype=np.float32)

    def inside(p):
        return (clip_width < p[0] < img_h - clip_width
                and clip_width < p[1] < img_w - clip_width)

    for ip, ep in zip(np.asarray(init_pts), np.asarray(end_pts)):
        if abs(ep[0] - ip[0]) < EPS and abs(ep[1] - ip[1]) < EPS:
            continue  # empty lane slot
        for p in (ip, ep):
            if inside(p):
                r, c = int(p[0]), int(p[1])
                np.maximum(out, gaussian_peak(img_h, img_w, r, c, sigma),
                           out=out)
                out[r, c] = 1.0
    return out


def select_and_order_lanes(seqs: List[np.ndarray], semantics: List[int],
                           top_k: int = 20,
                           col_range: Tuple[int, int] = (100, 1000),
                           min_row_extent: float = 10.0,
                           instance_ids: Sequence[int] = None):
    """Lane selection/canonicalisation (reference `convert_data.py:105-205`):

    keep lanes whose midpoint column lies in ``col_range`` and whose row
    extent exceeds ``min_row_extent``; keep the ``top_k`` lowest original
    instance ids; orient each seq top-to-bottom; re-number left-to-right by
    (start col, end col) lexsort.  Returns (seqs, semantics, orients).
    """
    if instance_ids is None:
        instance_ids = list(range(1, len(seqs) + 1))
    keep = []
    for i, s in enumerate(seqs):
        if len(s) < 2:
            continue
        mid = (s[0] + s[-1]) * 0.5
        if not (col_range[0] <= mid[1] <= col_range[1]):
            continue
        if abs(s[0][0] - s[-1][0]) <= min_row_extent:
            continue
        keep.append(i)
    if len(keep) > top_k:
        order = np.argsort([instance_ids[i] for i in keep])
        keep = [keep[j] for j in order[:top_k]]

    seqs = [np.asarray(seqs[i], dtype=np.float64).copy() for i in keep]
    semantics = [semantics[i] for i in keep]
    # top-to-bottom orientation
    seqs = [s[::-1] if s[0, 0] > s[-1, 0] else s for s in seqs]
    # left-to-right instance renumbering
    if seqs:
        start_col = np.array([s[0, 1] for s in seqs])
        end_col = np.array([s[-1, 1] for s in seqs])
        order = np.lexsort((end_col, start_col))
        seqs = [seqs[i] for i in order]
        semantics = [semantics[i] for i in order]
    orients = [orientation_classes(s) for s in seqs]
    return seqs, semantics, orients


def render_labels(seqs: List[np.ndarray], semantics: List[int],
                  orients: List[np.ndarray], img_h: int = 1152,
                  img_w: int = 1152) -> Dict[str, np.ndarray]:
    """Rasterise the full sparse label set for one tile."""
    sem_img = np.zeros((img_h, img_w), dtype=np.uint8)
    inst_img = np.zeros((img_h, img_w), dtype=np.uint8)
    ori_img = np.zeros((img_h, img_w), dtype=np.uint8)
    init_pts, end_pts = [], []
    for lane_id, (seq, sem, ori) in enumerate(zip(seqs, semantics, orients),
                                              start=1):
        sem_value = 128 if sem == 1 else 255  # solid=128, dashed=255 pixels
        rasterize_polyline(sem_img, seq, sem_value)
        rasterize_polyline(inst_img, seq, lane_id)
        rasterize_segments(ori_img, seq[:-1].astype(np.int64),
                           seq[1:].astype(np.int64), ori[:-1])
        init_pts.append(seq[0])
        end_pts.append(seq[-1])
    if init_pts:
        endp = endpoint_heatmap(np.array(init_pts), np.array(end_pts),
                                img_h, img_w)
    else:
        endp = np.zeros((img_h, img_w), dtype=np.float32)
    return {"semantic": sem_img, "instance": inst_img, "orient": ori_img,
            "endp": (endp * 255.0).astype(np.float32)}


def seq_sidecar(seqs, semantics, orients) -> List[Dict]:
    """Sparse-seq JSON records (reference `convert_data.py:54-69`)."""
    recs = []
    for i, (s, sem, ori) in enumerate(zip(seqs, semantics, orients), start=1):
        recs.append({
            "semantic": int(sem),
            "instance": i,
            "seq_len": len(s),
            "seq": np.asarray(s).tolist(),
            "init_vertex": np.asarray(s[0]).tolist(),
            "end_vertex": np.asarray(s[-1]).tolist(),
            "seq_orient": np.asarray(ori).tolist(),
        })
    return recs


def convert_annotation_file(seq_json_path: str, out_root: str,
                            top_k: int = 20, col_range=(100, 1000)) -> None:
    """Convert one dense annotation_seq JSON into the sparse label set
    (reference `convert_data.py:371-396`)."""
    with open(seq_json_path) as f:
        data = json.load(f)
    if data is None:
        return
    seqs = [np.asarray([v[:2] for v in a["seq"]], dtype=np.float64)
            for a in data]
    semantics = [a["semantic"] for a in data]
    instance_ids = [a.get("instance", i + 1) for i, a in enumerate(data)]
    seqs, semantics, orients = select_and_order_lanes(
        seqs, semantics, top_k=top_k, col_range=col_range,
        instance_ids=instance_ids)
    maps = render_labels(seqs, semantics, orients)

    stem = os.path.splitext(os.path.basename(seq_json_path))[0]
    from PIL import Image
    dirs = {k: os.path.join(out_root, f"sparse_{k}")
            for k in ("seq", "semantic", "instance", "orient", "endp")}
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)
    Image.fromarray(maps["semantic"]).save(
        os.path.join(dirs["semantic"], stem + ".png"))
    Image.fromarray(maps["instance"]).save(
        os.path.join(dirs["instance"], stem + ".png"))
    Image.fromarray(maps["orient"]).save(
        os.path.join(dirs["orient"], stem + ".png"))
    Image.fromarray(maps["endp"].astype(np.uint8)).save(
        os.path.join(dirs["endp"], stem + ".png"))
    with open(os.path.join(dirs["seq"], stem + ".json"), "w") as f:
        json.dump(seq_sidecar(seqs, semantics, orients), f, cls=NpEncoder)
