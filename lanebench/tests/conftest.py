"""Tiny cells for the benchmark's CPU tests: the program's tiny configs at
the shipped dtypes, small clouds and batches, the loops on the CPU."""

import json
import os
import sys
import time
import types

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY_TRAFFIC = dict(points=4096, clouds=8, batch=2, ring=4, loader_threads=2,
                    workers=2, sample_within_batches=2, sample_tiles=2,
                    trace_batches=2, trace_steps=2, warmup_batches=1)
# loose enough for any sound tiny run; the tests that need a failure
# plant a fault far outside them
TINY_LIMITS = {"input_gap": 0.01, "head_gap": 0.2, "loss_gap": 0.05,
               "grad_gap": 0.5, "change_gap": 0.5}
CELLS = {"flagship.serve_las": ("tiny_flagship", "serve_las"),
         "flagship.train": ("tiny_flagship", "train"),
         "lidar.train": ("tiny_lidar", "train")}


def tiny_cell(name, dtype=None):
    conf, traffic = CELLS[name]
    with open(os.path.join(HERE, conf + ".json")) as f:
        cfg = json.load(f)
    if dtype is not None:
        cfg["compute_dtype"] = cfg["train_compute_dtype"] = dtype
    with open(os.path.join(ROOT, "lanebench", "traffic",
                           traffic + ".json")) as f:
        tr = json.load(f)
    tr.update(TINY_TRAFFIC)
    return types.SimpleNamespace(name=name, config=cfg, traffic=tr,
                                 limits=dict(TINY_LIMITS))


def run_tiny(cell, seed=3000000019, seconds=3.0, trace=False):
    """A run of a tiny cell's loop on the CPU (the look for a card
    skipped): the run's record."""
    import torch

    from lanebench import core
    torch.set_num_threads(2)
    rec = core.Run(cell, seconds, trace)
    rec.device_kind = "cpu"
    core.loop(cell).run(cell, rec, seed, seconds, torch.device("cpu"),
                        time.perf_counter())
    return rec


@pytest.fixture
def card():
    """The card, or a skip where this host has none (decided here, at
    run time, never at import)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)
