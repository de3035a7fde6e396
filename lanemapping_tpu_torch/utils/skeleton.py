"""Binary skeletonization (Zhang-Suen thinning), vectorised NumPy (a copy of
`lanemapping_tpu/utils/skeleton.py`).

Replaces skimage's Cython ``skeletonize(method='lee')`` used by the reference
metrics (`baseline/utils/metric_utils.py:429,453` there); with the
10-px buffered KD-tree matching both thinning variants give identical F1.
"""

from __future__ import annotations

import numpy as np


def _neighbours(img: np.ndarray):
    """The 8 neighbours P2..P9 (clockwise from north) as shifted arrays."""
    p2 = np.roll(img, 1, 0)
    p3 = np.roll(np.roll(img, 1, 0), -1, 1)
    p4 = np.roll(img, -1, 1)
    p5 = np.roll(np.roll(img, -1, 0), -1, 1)
    p6 = np.roll(img, -1, 0)
    p7 = np.roll(np.roll(img, -1, 0), 1, 1)
    p8 = np.roll(img, 1, 1)
    p9 = np.roll(np.roll(img, 1, 0), 1, 1)
    return p2, p3, p4, p5, p6, p7, p8, p9


def skeletonize(binary: np.ndarray, max_iter: int = 10000) -> np.ndarray:
    """Zhang-Suen thinning of a {0,1} image to a 1-px skeleton."""
    img = (binary > 0).astype(np.uint8)
    img[0, :] = img[-1, :] = img[:, 0] = img[:, -1] = 0  # guard the wrap
    for _ in range(max_iter):
        changed = False
        for phase in (0, 1):
            p = _neighbours(img)
            ring = np.stack(list(p) + [p[0]], axis=0)  # p2..p9,p2
            a = np.sum((ring[:-1] == 0) & (ring[1:] == 1), axis=0)
            b = np.sum(np.stack(p), axis=0)
            p2, p3, p4, p5, p6, p7, p8, p9 = p
            if phase == 0:
                c1 = p2 * p4 * p6
                c2 = p4 * p6 * p8
            else:
                c1 = p2 * p4 * p8
                c2 = p2 * p6 * p8
            cond = ((img == 1) & (b >= 2) & (b <= 6) & (a == 1)
                    & (c1 == 0) & (c2 == 0))
            if cond.any():
                img[cond] = 0
                changed = True
        if not changed:
            break
    return img
