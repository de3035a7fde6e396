"""Device time of every kernel that the binning wrappers K1 (``bev_bin_mean``)
and K1z (``voxel_bin_mean``) launch, read from ``torch.profiler`` on the
card.

    python -m lanemapping_tpu_torch.tools.profile_binning [--batch 8]
        [--points 524288] [--iters 20]

The inputs are seeded lane-structured clouds (``data/synthetic.py::
lane_structured_points``, 15% road paint), binned by K1 onto the flagship's
1152 x 1152 grid and by K1z onto the LiDAR config's 576 x 576 x 10 grid, as
the two slices do.  Prints the card and, as its last line, one JSON object:
for each wrapper, each pass's device microseconds per call (the mean over
``--iters`` calls), their sum, and the host microseconds per call under the
profiler.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from ..data.synthetic import lane_structured_points, random_lane_seqs
from ..kernels.bev_bin import bev_bin_mean
from ..kernels.voxel_bin import voxel_bin_mean
from .las2bev import DEFAULT_PC_RANGE

IMG = 1152
GRID = (576, 576, 10)


def clouds(batch: int, n_points: int) -> torch.Tensor:
    """[batch, n_points, 4] float32 clouds, cloud i from seed i."""
    out = []
    for i in range(batch):
        rng = np.random.RandomState(i)
        seqs = random_lane_seqs(rng, img=IMG, n_lanes=5)
        sem = rng.randint(1, 3, len(seqs))
        out.append(lane_structured_points(seqs, sem, IMG, rng, n_points))
    return torch.from_numpy(np.stack(out).astype(np.float32))


# the passes of the wrappers, by a part of their kernel's name
PASSES = {"memset": "Memset", "hist": "band_hist_kernel",
          "scan": "band_scan_kernel", "scatter": "band_scatter_kernel",
          "mean": "_mean_kernel"}


def profile(fn, iters: int):
    """{kernel name: device us per call}, and host us per call (the host
    clock over the calls, the profiler's own cost included)."""
    from torch.profiler import ProfilerActivity, profile as torch_profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(2):
        with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            host_us = (time.perf_counter() - t0) / iters * 1e6
            torch.cuda.synchronize()
        kernels = {}
        for ev in prof.key_averages():
            us = getattr(ev, "device_time_total", None)
            if us is None:
                us = ev.cuda_time_total
            if us > 0:
                kernels[ev.key[:80]] = us / iters
        if kernels:
            break
        # the second profiler session of one process on the H100 handed
        # back a trace with no kernel in it once: the calls are profiled
        # once more (a second empty trace fails the caller's check)
        print("[profile_binning] the profiler recorded no kernel; "
              "profiling again", flush=True)
    return kernels, host_us


def pass_split(kernels) -> dict:
    """{pass: device us per call} of ``profile``'s kernels, by ``PASSES``;
    a kernel that is none of them is kept under its own name."""
    split = {}
    for name, us in kernels.items():
        key = next((p for p, part in PASSES.items() if part in name), name)
        split[key] = split.get(key, 0.0) + us
    return split


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--points", type=int, default=1 << 19)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_binning needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    pts = clouds(args.batch, args.points).cuda()
    msk = torch.ones(pts.shape[:2], dtype=torch.bool, device="cuda")
    result = {"card": card, "batch": args.batch, "points": args.points}
    for name, fn in (
            ("bev_bin_mean", lambda: bev_bin_mean(
                pts, msk, DEFAULT_PC_RANGE, IMG, flip_rows=True)),
            ("voxel_bin_mean", lambda: voxel_bin_mean(
                pts, msk, DEFAULT_PC_RANGE, GRID))):
        kernels, host_us = profile(fn, args.iters)
        split = pass_split(kernels)
        result[name] = {"device_us": split,
                        "device_us_sum": sum(split.values()),
                        "host_us": host_us}
        print(f"{name}: host {host_us:.1f} us/call under the profiler; "
              "device " + ", ".join(f"{k} {v:.2f} us"
                                    for k, v in split.items()), flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
