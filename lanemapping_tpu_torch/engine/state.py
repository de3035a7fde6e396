"""Batch helpers of the engine (``is_mono_batch`` of
`lanemapping_tpu/engine/state.py`, copied)."""

from __future__ import annotations

import numpy as np


def is_mono_batch(a) -> bool:
    """Whether an image batch is channel-replicated mono ([B,H,W,3] with all
    three channels identical).  BEV intensity tiles are one LiDAR return
    intensity replicated into 3 PNG channels (reference
    `laserlane_proposals.py:85-98` loads them unchanged); such a batch can
    ship as ONE channel and be broadcast back on the device — 3x less
    upload, bit-identical activations."""
    return bool(a.ndim == 4 and a.shape[-1] == 3
                and np.array_equal(a[..., 0], a[..., 1])
                and np.array_equal(a[..., 1], a[..., 2]))
