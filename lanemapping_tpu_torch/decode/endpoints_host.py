"""Exact host-side endpoint extraction with the adaptive top-K loop.

A copy of `lanemapping_tpu/decode/endpoints_host.py`.

Literal-semantics implementation of the reference's endpoint decode
(`baseline/models/heads/polyline_fpn_vit_vertex_2.py:638-688,
903-924`): grow K from num_cls*2*10 by 10 until clustering the top-K scores
yields > 4 clusters or K > 500.  The on-device XLA decode
(`lane_decode.decode_endpoints`) takes the fixed K=num_cls*2*10 snapshot;
this module exists for parity studies against released checkpoints and as
the eval-time fallback when exactness matters more than staying on-device.
"""

from __future__ import annotations


import numpy as np


def cluster_reps(pts: np.ndarray, radius: float) -> np.ndarray:
    """Single-linkage radius clustering; one representative per cluster —
    the member nearest the centroid — ordered by cluster size ascending."""
    from scipy.spatial import cKDTree

    n = len(pts)
    if n == 0:
        return np.zeros((0, 2))
    tree = cKDTree(pts)
    labels = np.arange(n)
    for i in range(n):
        for j in tree.query_ball_point(pts[i], radius):
            a, b = labels[i], labels[j]
            if a != b:
                labels[labels == max(a, b)] = min(a, b)
    reps, sizes = [], []
    for lbl in np.unique(labels):
        members = pts[labels == lbl]
        cent = members.mean(axis=0)
        reps.append(members[np.argmin(((members - cent) ** 2).sum(1))])
        sizes.append(len(members))
    order = np.argsort(sizes, kind="stable")
    return np.asarray(reps)[order]


def decode_endpoints_host(endp_logits: np.ndarray, num_cls: int,
                          clip_w: int = 20, radius: float = 20.0,
                          k_step: int = 10, k_max: int = 500) -> np.ndarray:
    """[H,W] logits -> [M,2] endpoint representatives (adaptive-K loop)."""
    h, w = endp_logits.shape
    inner = endp_logits[clip_w:h - clip_w, clip_w:w - clip_w]
    score = 1.0 / (1.0 + np.exp(-inner.astype(np.float64)))
    flat = score.reshape(-1)
    order = np.argsort(-flat, kind="stable")
    iw = w - 2 * clip_w

    k = num_cls * 2 * 10
    while True:
        top = order[:k]
        pts = np.stack([top // iw, top % iw], axis=1).astype(np.float64)
        reps = cluster_reps(pts, radius)
        if len(reps) > 4 or k > k_max:
            break
        k += k_step
    return reps + clip_w


def endpoint_map_host(endp_logits: np.ndarray, num_cls: int,
                      **kw) -> np.ndarray:
    """Binary endpoint map (the reference's ``arr_endp``)."""
    h, w = endp_logits.shape
    out = np.zeros((h, w))
    reps = decode_endpoints_host(endp_logits, num_cls, **kw)
    if len(reps):
        out[reps[:, 0].astype(int), reps[:, 1].astype(int)] = 1.0
    return out
