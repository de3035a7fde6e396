"""The binning kernels' device time in a trace, by launch.

A K1 launch (`csrc/bev_bin.cu`) is the band bucketing of
`csrc/bin_bands.cuh` over ``BevBinner`` (histogram, scan, scatter) and
``bev_mean_kernel``; a K1z launch (`csrc/voxel_bin.cu`) is the same
bucketing over ``VoxelBinner`` and ``voxel_mean_kernel``.  The scan is
not templated on the binner: where both kernels ran it is shared out by
launches."""

from __future__ import annotations

from typing import Optional

MEAN = {"k1": "bev_mean_kernel", "k1z": "voxel_mean_kernel"}
BINNER = {"k1": "BevBinner", "k1z": "VoxelBinner"}


def seconds_per_launch(trace, kernel: str) -> Optional[float]:
    """Device seconds of one launch of ``kernel`` ("k1" or "k1z"), or None
    where the trace holds no launch of it."""
    if trace is None:
        return None
    n = trace.time_of(lambda s: MEAN[kernel] in s)[1]
    if n == 0:
        return None
    other = "k1z" if kernel == "k1" else "k1"
    n_other = trace.time_of(lambda s: MEAN[other] in s)[1]
    own = trace.time_of(lambda s: MEAN[kernel] in s
                        or BINNER[kernel] in s)[0]
    scan = trace.time_of(lambda s: "band_scan_kernel" in s)[0]
    return (own + scan * n / (n + n_other)) / n


def roofline_pct(run, kernel: str) -> Optional[float]:
    """The kernel's share of its bandwidth roofline: its bytes (each input
    and output byte once, `lanebench/flops.py`) over the card's published
    memory rate, over its device time a launch."""
    from . import core

    t = seconds_per_launch(run.trace, kernel)
    nbytes = run.kernel_bytes.get(kernel)
    if t is None or not nbytes:
        return None
    bw = core.peaks(run.device_kind)["hbm_bytes_per_s"]
    return 100.0 * nbytes / bw / t
