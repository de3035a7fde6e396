"""The trace reduction on a small synthetic trace: busy time is the union
of device activity inside the window mark, idle gaps go to what the host
was doing, and a binning kernel's time a launch and roofline share follow
from its kernels."""

import json
import types

import pytest


def _trace(tmp_path):
    ev = [
        # the window: 0-1000 us; the benchmark's span 0-600 us
        {"ph": "X", "cat": "user_annotation", "name": "lanebench.window",
         "ts": 0, "dur": 1000},
        {"ph": "X", "cat": "user_annotation", "name": "lanebench.step",
         "ts": 0, "dur": 600},
        {"ph": "X", "cat": "cpu_op", "name": "aten::item", "ts": 650,
         "dur": 300},
        # K1: bucketing and mean, two launches; overlapping kernels count once
        {"ph": "X", "cat": "kernel", "name": "void bins::band_hist_kernel<"
         "BevBinner>(...)", "ts": 100, "dur": 50},
        {"ph": "X", "cat": "kernel", "name": "band_scan_kernel(...)",
         "ts": 150, "dur": 10},
        {"ph": "X", "cat": "kernel", "name": "bev_mean_kernel(...)",
         "ts": 160, "dur": 40},
        {"ph": "X", "cat": "kernel", "name": "void bins::band_hist_kernel<"
         "BevBinner>(...)", "ts": 300, "dur": 50},
        {"ph": "X", "cat": "kernel", "name": "band_scan_kernel(...)",
         "ts": 350, "dur": 10},
        {"ph": "X", "cat": "kernel", "name": "bev_mean_kernel(...)",
         "ts": 360, "dur": 40},
        {"ph": "X", "cat": "kernel", "name": "gemm", "ts": 380, "dur": 100},
        # a copy past the window's end is clipped to it
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 900,
         "dur": 200},
    ]
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": ev}))
    from lanebench.core import Trace
    return Trace(str(p))


def test_busy_window_and_gaps(tmp_path):
    t = _trace(tmp_path)
    assert t.window_s == pytest.approx(1e-3)
    # 100-200, 300-480, 900-1000
    assert t.busy_s == pytest.approx(380e-6)
    gaps = dict(t.idle_gaps)
    # 0-100 and 200-300 lie under the step's span; the gap 480-900 goes
    # whole to the operator that covers most of it
    assert gaps["lanebench.step"] == pytest.approx(200e-6)
    assert gaps["aten::item"] == pytest.approx(420e-6)
    ops = dict(t.breakdown()["device_ops"])
    assert ops["Memcpy HtoD"] == pytest.approx(100e-6)  # clipped
    assert ops["gemm"] == pytest.approx(100e-6)


def test_binning_roofline_from_the_trace(tmp_path):
    from lanebench import binning, flops
    t = _trace(tmp_path)
    assert binning.seconds_per_launch(t, "k1") == pytest.approx(100e-6)
    assert binning.seconds_per_launch(t, "k1z") is None
    run = types.SimpleNamespace(
        trace=t, device_kind="NVIDIA H100 80GB HBM3",
        kernel_bytes={"k1": flops.k1_bytes(8, 1 << 19, 4, 1152)})
    # 156,237,824 bytes at 3.35e12 B/s is 46.64 us of a 100 us launch
    assert binning.roofline_pct(run, "k1") == pytest.approx(46.638, rel=1e-4)
