"""Device time of every kernel that the binning wrappers K1 (``bev_bin_mean``)
and K1z (``voxel_bin_mean``) launch, read from ``torch.profiler`` on the
card.

    python -m lanemapping_tpu_torch.tools.profile_binning [--batch 8]
        [--points 524288] [--iters 20] [--cols 4 [12 ...]]
        [--resize-tiles 101 102]

The inputs are seeded lane-structured clouds (``data/synthetic.py::
lane_structured_points``, 15% road paint), binned by K1 onto the flagship's
1152 x 1152 grid and by K1z onto the LiDAR config's 576 x 576 x 10 grid, as
the two slices do; K1z at each of ``--cols`` columns a point (x, y, z,
intensity, then seeded uniform columns; the LiDAR config has 4), under
``voxel_bin_mean`` at 4 and ``voxel_bin_mean_C<n>`` otherwise.  Prints the
card and, as its last line, one JSON object: for each wrapper, each pass's
device microseconds per call (the mean over ``--iters`` calls), their sum,
and the host microseconds per call under the profiler.  With
``--resize-tiles``, also (``resize_us_a_tile``) the device microseconds a
tile of the flagship FPN's p2 resize, which ``ops/interp.py`` splits over
the batch from 102 tiles on, and of a 3x3 convolution at p2, at each of
those batch sizes.
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


def resize_costs(tiles, iters: int) -> dict:
    """Device us a tile, bf16, channels-last, at each batch size of
    ``tiles``: the FPN's p2 resize ([n, 256, 144, 144] -> 288^2, split by
    ``resize_bilinear_ac`` where it reaches ``RESIZE_MAX_ELEMENTS``) and a
    3x3 256 -> 128 convolution at p2 (the semantic branch; PyTorch runs a
    cuDNN convolution beyond 2^31 - 1 elements in batch chunks itself).
    {"resize": {n: us}, "conv": {n: us}}."""
    from ..ops.interp import resize_bilinear_ac

    side = IMG // 4
    gen = torch.Generator(device="cuda").manual_seed(0)
    conv = torch.nn.Conv2d(256, 128, 3, padding=1).cuda().to(
        torch.bfloat16).to(memory_format=torch.channels_last)
    costs = {"resize": {}, "conv": {}}
    with torch.inference_mode():
        for n in tiles:
            x = torch.randn((n, 256, side // 2, side // 2), generator=gen,
                            device="cuda", dtype=torch.bfloat16).to(
                memory_format=torch.channels_last)
            kernels, _ = profile(lambda: resize_bilinear_ac(x, side, side),
                                 iters)
            costs["resize"][n] = sum(kernels.values()) / n
            p = resize_bilinear_ac(x, side, side)
            del x
            kernels, _ = profile(lambda: conv(p), iters)
            costs["conv"][n] = sum(kernels.values()) / n
            del p
            torch.cuda.empty_cache()
    return costs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--points", type=int, default=1 << 19)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--cols", type=int, nargs="+", default=[4],
                    help="K1z's columns a point, one run each (>= 3)")
    ap.add_argument("--resize-tiles", type=int, nargs="*", default=[],
                    help="batch sizes of the p2 resize and convolution")
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
    runs = [("bev_bin_mean", lambda: bev_bin_mean(
        pts, msk, DEFAULT_PC_RANGE, IMG, flip_rows=True))]
    for c in args.cols:
        extra = torch.rand(pts.shape[:2] + (max(c - 4, 0),),
                           generator=torch.Generator().manual_seed(c))
        pts_c = torch.cat([pts[..., :c], extra.cuda()], -1).contiguous()
        runs.append(("voxel_bin_mean" if c == 4 else f"voxel_bin_mean_C{c}",
                     lambda p=pts_c: voxel_bin_mean(p, msk, DEFAULT_PC_RANGE,
                                                    GRID)))
    for name, fn in runs:
        kernels, host_us = profile(fn, args.iters)
        split = pass_split(kernels)
        result[name] = {"device_us": split,
                        "device_us_sum": sum(split.values()),
                        "host_us": host_us}
        print(f"{name}: host {host_us:.1f} us/call under the profiler; "
              "device " + ", ".join(f"{k} {v:.2f} us"
                                    for k, v in split.items()), flush=True)
    if args.resize_tiles:
        del pts, msk, runs
        torch.cuda.empty_cache()
        result["resize_us_a_tile"] = resize_costs(args.resize_tiles,
                                                  args.iters)
        print("device us a tile at " + " / ".join(
            map(str, args.resize_tiles)) + " tiles: " + "; ".join(
            f"{k} " + " / ".join(f"{v[n]:.2f}" for n in args.resize_tiles)
            for k, v in result["resize_us_a_tile"].items()), flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
