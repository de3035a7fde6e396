"""The benchmark's plain reference: a frozen copy of the lane mapper's
model, loss, decode and host postprocess in plain PyTorch and NumPy.

It imports nothing of the program.  The binning kernels are their plain
``index_put_`` forms (`kernels/`), the host tracker is the NumPy one
(`decode/postprocess.py`, no native library), and the collectives are
their values at a world of one (`parallel/dist.py`).  The FLOP counts of
the benchmark (`lanebench/flops.py`) are taken on this model, so no change
to the program moves them.
"""

from __future__ import annotations

from typing import Any, Dict


class ConfigDict(dict):
    """dict with attribute access, recursively applied to nested dicts."""

    def __init__(self, *args, **kwargs):
        super().__init__()
        for k, v in dict(*args, **kwargs).items():
            self[k] = v

    @staticmethod
    def _wrap(v):
        if isinstance(v, dict) and not isinstance(v, ConfigDict):
            return ConfigDict(v)
        if isinstance(v, (list, tuple)):
            return type(v)(ConfigDict._wrap(x) for x in v)
        return v

    def __setitem__(self, k, v):
        super().__setitem__(k, ConfigDict._wrap(v))

    def __setattr__(self, k, v):
        self[k] = v

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError:
            raise AttributeError(k)


def build_model(cfg: Dict[str, Any]):
    """The config's net (eval mode, float32, on the CPU), its weights as
    PyTorch initialises them: the benchmark loads its own seeded weights
    into it (`lanebench/weights.py`)."""
    from .models import (column_head, lidar_encoder,  # noqa: F401
                         resnet_fpn, vit)
    from .models.nets import Detector1stage  # noqa: F401
    from .registry import build_net

    return build_net(ConfigDict(cfg)).eval()
