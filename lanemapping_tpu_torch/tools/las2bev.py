"""Las2BEV settings (the ``las2bev_params`` of
`lanemapping_tpu/tools/las2bev.py`, copied).  The rasterization itself is
`ops/voxelize.py::bev_image_from_points`; the offline PNG writer waits for a
later slice."""

from __future__ import annotations

from typing import Dict

DEFAULT_PC_RANGE = (-15.0, -25.0, -2.0, 15.0, 25.0, 2.0)
DEFAULT_GAIN = 0.900
DEFAULT_BIAS = 0.1535


def las2bev_params(cfg=None) -> Dict:
    """Las2BEV knobs from a config's ``las2bev`` dict (all optional):
    ``pc_range``, ``gain``, ``bias``, ``fill_iters``.  The gain/bias defaults
    are calibrated to the synthetic MLS intensity model; calibrate per
    sensor for real surveys."""
    p = dict(cfg.get("las2bev", {})) if cfg is not None else {}
    p.setdefault("pc_range", cfg.get("lidar_point_cloud_range",
                                     DEFAULT_PC_RANGE)
                 if cfg is not None else DEFAULT_PC_RANGE)
    p.setdefault("gain", DEFAULT_GAIN)
    p.setdefault("bias", DEFAULT_BIAS)
    p.setdefault("fill_iters", 6)
    return p
