#!/usr/bin/env python3
"""Chip smoke test of ``lanemapping_tpu_torch`` on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Run from the root of a checkout.  It imports nothing of JAX nor of the JAX
package, and fails (non-zero exit, no result line) without a CUDA device
or outside a checkout.  Phases, each of which fails the run:

1. card: ``nvidia-smi`` name and power limit, ``torch.cuda`` device name;
2. build K1 (``lanemapping_tpu_torch/csrc/bev_bin.cu``) and K1z
   (``csrc/voxel_bin.cu``), both on the band bucketing of
   ``csrc/bin_bands.cuh``, with ``nvcc`` from the checkout's sources, one
   ``nvcc`` each, started together, printing the build times and
   ``-Xptxas -v``;
3. K1 (``bev_bin_mean``) against its plain PyTorch version on the card at
   the slice's shapes (8 seeded lane-structured clouds of 2^19 points,
   1152^2 grid): counts exactly equal, means within rtol 1e-5 / atol 1e-5;
   times, in turns, of the kernel, the plain version and one
   ``index_put_(accumulate=True)`` call (the library yardstick, used
   nowhere in the port), beside the bound (bytes moved over 3.35 TB/s),
   each both behind a device sleep and back to back (``cuda_ms``), with the
   host's time per call; then each pass's device time from
   ``torch.profiler`` on the same wrapper, with the bytes it moves, and
   one ``torch.zeros`` of the two 1152^2 outputs the earlier atomic kernel
   had to zero-fill;
4. the slice at full width: 16 seeded ``.las`` clouds of 2^19 points ->
   ``tools/stream_map --from-las`` on the flagship config
   (``configs/Proj_polyline_fpn_vit_vertex_2.py``), seeded random weights,
   bf16, batch 8 -> one lane JSON per tile; K1's launch count is zeroed
   just before and read just after, and must be > 0; every head map of a
   batch is finite and of the expected shape;
5. the port on the card against the port on the CPU at
   ``configs/tiny_test.py`` in float32 with TF32 off: every head map within
   rel-max 2e-3, the same lane records (columns to 1e-3 px);
6. K1z (``voxel_bin_mean``) against its plain PyTorch version on the card
   at the LiDAR slice's shapes (the first 8 clouds of phase 7's dataset,
   2^19 points each, 576x576x10 grid, C = 4): means within rtol 1e-5 /
   atol 1e-5; times, as in phase 3, of the kernel, the plain version and
   one ``index_reduce_(..., 'mean', include_self=False)`` call on
   precomputed voxel indices of the valid points (the library yardstick),
   with one ``index_put_(accumulate=True)`` of [N, C+1] rows beside it,
   against the bound; then each pass's device time with its bytes, and one
   ``torch.zeros`` of the [B,Y,X,Z,C+1] sums and counts the earlier atomic
   kernel had to zero-fill;
7. the LiDAR slice at full width: 16 tiles of a seeded LaserLane dataset
   (``data/synthetic.generate_dataset``, 1152 px, 2^19 points per cloud)
   -> ``tools/stream_map --split infer_only`` on the LiDAR config
   (``configs/Proj_polyline_lidarconv_vit_vertex_2.py``), seeded random
   weights, batch 8 -> one lane JSON per tile; the launch counts are zeroed
   just before and read just after, and K1z's must be > 0; every head map
   of a batch is finite and of the expected shape;
8. the port on the card against the port on the CPU at
   ``configs/tiny_test_lidar.py`` in float32 with TF32 off: the z-fold
   planes within 1e-5 with equal counts, every head map within rel-max
   2e-3, the same lane records (columns to 1e-3 px);
9. flagship training at full width: ``Runner.train(max_iters=8)`` on the
   flagship config (bf16, Adam + cosine, batch 8, seeded random weights)
   over phase 7's dataset, whose 16 tiles all train (2 batches per pass);
   every loss term finite at every step, no NaN-guard skip, the last
   pass's loss below the first; s/step from CUDA events after the warm-up
   step, train tiles/s, ``max_memory_allocated``, one more step under
   ``torch.profiler`` (its top ops by device time), the forward + backward
   ms of the fused seg focal and the full-resolution CE and endpoint
   focal at the step's shapes; then ``epoch_1`` saved, a new Runner's
   ``resume_latest`` bit-identical (parameters, buffers, optimizer,
   scheduler, step, generator), and one ``validate`` on the valid split;
10. the same for the LiDAR config (float32 on bf16-rounded weights, 2^19
   points per cloud, 6 steps); K1z's launch count is zeroed before the
   run and read after, and must be > 0, and the voxelized plane must
   enter autograd as a leaf;
11. three train steps of the port on the card against the port on the CPU
   at both tiny configs in float32 with TF32 off, from the same weights,
   seeded mid-training Adam state and batch (a tenth of the configs' lr,
   as the CPU parity tests): every loss term within rel 1e-4 at every
   step, every parameter and BatchNorm buffer within rel-max 2e-3.

12. the four other shipped configs at full width, seeded random weights:
   RowRef (``configs/Proj28_GFC-T3_RowRef_82_73_laser.py``: FPN, ViT,
   RowSharNotReducRef), Seg (``Proj28_GFC-T3_Seg_82_11_laser.py``: the
   legacy Detector, ResNet projector, ViT with shared MLP, GridSeg), FPN
   Seg (``Proj_FPN_Seg.py``: the Segmentor) and MixSeg
   (``Proj_polyline_fpn_mixseg_vertex.py``: the flagship with MixSegNet):
   ``Runner.validate`` over phase 7's 16 tiles at batch 8, then the
   config's export driver over 8 of them (``infer_grid_and_export``,
   ``infer_segmentor_and_export`` or ``infer_and_export``,
   ``write_view=False``): one lane JSON per tile with the record schema
   (the Segmentor returns its metrics instead), every head map of a batch
   finite and of the expected shape, the metric keys present; device ms
   per batch of the forward and the decode (CUDA events) and host ms of
   the rest; K1's and K1z's launch counts over the run;
13. ``Runner.train(max_iters=3)`` for each of the four at its own batch (8,
   4, 6, 8) and training precision (bf16 but the Segmentor, float32):
   every loss term finite, no NaN-guard skip, s/step from CUDA events
   after the warm-up step, peak ``max_memory_allocated``, one more step
   under ``torch.profiler``;
14. each of the four on the card against the port on the CPU at tiny
   widths, float32 with TF32 off, from the same seeded weights: the
   forward's outputs within rel-max 2e-3, the same decoded maps and lane
   records, one train step's loss terms within rel 1e-4.
15. the 3-D lane map: transform params for phase 7's tiles (written after
   the dataset, from their own seeds), then ``tools/stream_map
   --split infer_only --params-dir`` on the LiDAR config and
   ``LaneMapper(flagship, device="cuda").map_directory(params_dir=...)``
   over the same 16 tiles: every lifted vertex 3-D and finite, the merged
   and down-sampled maps non-empty, the 3-D files of the 8 forked workers
   equal to a serial lift and merge of the same 2-D lanes; forked workers
   are marked by torch (a CUDA call there raises) and the card still works
   after them; lanes, vertices and the lift's wall time; K1z's launch
   count on the stream > 0;
16. the flagship with ``column_att``, then with
   ``column_transformer_decoder``, at full width (JAX's default token
   widths), bf16, batch 8: ``tools/stream_map --from-las`` over phase 4's
   clouds (K1's launch count > 0; lane JSONs and head maps checked as in
   phase 4), forward and decode ms per batch and tiles/s; then
   ``Runner.train(max_iters=3)`` over phase 7's dataset: s/step after the
   warm-up step, peak ``max_memory_allocated``, every loss term finite;
17. each branch's head at tiny widths on the card against the CPU, float32
   with TF32 off, same seeded weights and inputs (the encoder's maps as
   fixed seeded logits): outputs within rel-max 1e-5, identical lane
   records at weight seeds whose decisions clear their thresholds by
   1e-4 (asserted), and three steps of the port's train step from a
   seeded mid-training Adam state with every loss term within rel 1e-6.
18. the rest of the model zoo at full width: the flagship with
   ``heads.type=RowSharNotReducRef_Base`` (the head's default token widths,
   bf16, batch 8), ``tools/stream_map --from-las`` over phase 4's clouds
   (K1 launched once per batch and once for the warm-up; lane JSONs and
   head maps checked as in phase 4),
   then ``Runner.train(max_iters=3)`` over phase 7's dataset; the flagship
   trained 3 steps with ``s2d_stem``, ``endp_head_extra``, ``remat`` and
   ``optimizer.mu_dtype=bfloat16``, then 3 with ``remat_policy=dots``
   (the trunk checkpointed, the flags and the bf16-moment Adam present;
   one step of that Adam timed against ``torch.optim.Adam`` on the same
   parameters);
   an s2d stem with a loaded 7x7 kernel against the 7x7 conv at
   [8,3,1152,1152] float32, TF32 off, within rel-max 1e-5; the nine
   ResnetFPN backbones (``num_channels=64``) at the flagship's correlator
   input [8,64,144,144] and Swin-T (embed 96, depths 2-2-6-2, heads
   3-6-12-24, window 7) at [8,3,896,896], bf16, training-mode forward +
   backward ms (CUDA events) and peak ``max_memory_allocated``;
19. phase 18's models at tiny widths on the card against the CPU, float32
   with TF32 off: the Base head as phase 17 checks the branches (outputs
   within rel-max 1e-5, identical lane records, 3 steps' loss terms within
   rel 1e-6); 3 steps of the tiny config with every flag of phase 18 as
   phase 11 checks them (loss terms within 1e-4, parameters and buffers
   within rel-max 2e-3); the nine family backbones and the JAX package's
   test Swin in eval and train mode within rel-max 1e-5.
20. data parallelism on the one card (`lanemapping_tpu_torch/parallel/`),
   over phase 7's dataset: (a) the flagship at full width, bf16, batch 8,
   2 steps in a 1-rank NCCL group and twice with no group: no collective
   called at a world of one, the first step's loss terms bit-identical,
   the parameter digest after 2 steps within rel 1e-5 of the first
   no-group run's (the step is not bit-reproducible on the card: the
   bilinear upsample's backward accumulates with atomics, and two
   no-group runs differ); (b) two ranks sharing the card over gloo
   (``torch.multiprocessing`` ranks of this script, ``dist_rank``), the
   flagship in float32 with TF32 off at a tenth of its lr, global batch 8
   as 4+4, 3 steps and a validate, against one process at the bars of
   `tools/multihost_test.py` (losses rel 1e-3, digest rel 1e-5, metrics
   abs 5e-2), the ranks bit-identical to each other; (c) the flagship's
   bf16 on the two ranks, 4 steps: s/step per rank (CUDA events), peak
   ``max_memory_allocated`` per rank, and the all-reduce ops' host ms
   over one step under ``torch.profiler``; (d) the LiDAR config on the
   two ranks, 2 steps: K1z launched once per step on each rank;
21. ``tools/stream_map --from-las`` over ``devices=[cuda:0, cuda:0]`` (two
   model replicas, each batch of 8 split 4+4) against one replica at
   batch 4 (the forwards' shapes equal, so the card picks the same
   kernels), phase 4's clouds, float32 with TF32 off: every head map and
   every continuous decode array within rel-max 1e-5 (the argmax,
   threshold and endpoint decisions are counted where they differ: at
   batch 8 against 4 they flip where the kernels' rounding does), one
   lane JSON per tile, K1 launched once per replica per batch (the
   warm-up batch included).

Phases 9, 10, 12, 13, 15, 16 and 18 run with PyTorch's default precision
flags (TF32 convolutions on) but where they say otherwise.  Each phase
prints its wall time.  Before the last line it prints ``{"kernels":
[...]}`` (with each kernel's launches on the serving and the training
path, the four configs of phases 12-13, the 3-D map paths of phase 15,
the branches of phase 16, phase 18's Base head and flag runs, K1z's per
rank in phase 20(d) and K1's over phase 21's two replicas); the last
line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

import copy
import json
import math
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
FLAGSHIP = os.path.join(HERE, "configs", "Proj_polyline_fpn_vit_vertex_2.py")
TINY = os.path.join(HERE, "configs", "tiny_test.py")
LIDAR = os.path.join(HERE, "configs",
                     "Proj_polyline_lidarconv_vit_vertex_2.py")
TINY_LIDAR = os.path.join(HERE, "configs", "tiny_test_lidar.py")
# the other shipped configs (phases 12-14): file, batch of its training
ZOO = {"rowref": ("Proj28_GFC-T3_RowRef_82_73_laser.py", 8),
       "gridseg": ("Proj28_GFC-T3_Seg_82_11_laser.py", 4),
       "fpnseg": ("Proj_FPN_Seg.py", 6),
       "mixseg": ("Proj_polyline_fpn_mixseg_vertex.py", 8)}
# phase 14's tiny widths: 192 px tiles (S = 24), ResNet-18 trunks, a
# one-block correlator of width 128, float32; weight seeds that put every
# decision of the forward and decode on phase 14's tiles at least 1.7e-5
# from its threshold (row argmaxes and gates, grid confidence and class,
# segmentation classes, endpoint top-k, proposal confidence and column
# argmax; measured on the CPU)
_TINY_VIT = {"backbone.image_size": 24, "backbone.dim": 128,
             "backbone.depth": 1, "backbone.heads": 4,
             "backbone.dim_head": 32}
ZOO_TINY = {
    "rowref": {**_TINY_VIT, "heads.dim_feat": 2, "heads.row_size": 24,
               "heads.dim_shared": 32, "heads.dim_token": 64,
               "heads.tr_heads": 4, "heads.tr_dim_head": 16,
               "heads.tr_mlp_dim": 128, "seed": 17},
    "gridseg": {**_TINY_VIT, "backbone.output_channels": 16,
                "heads.num_1": 16, "heads.num_2": 32, "seed": 3},
    "fpnseg": {"seed": 18},
    "mixseg": {"backbone.image_size": 24, "backbone.dim": 128,
               "backbone.depth": 1, "heads.row_size": 24,
               "heads.num_prop": 12, "heads.dim_shared": 32, "seed": 5},
}
ZOO_TINY_COMMON = {"list_img_size_xy": [192, 192],
                   "pcencoder.resnet": "resnet18", "batch_size": 2,
                   "workers": 0, "train_compute_dtype": "float32"}
B, N_POINTS, IMG = 8, 1 << 19, 1152
N_CLOUDS = 16
GRID = (576, 576, 10)  # the LiDAR config's voxel grid, x, y, z
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet, at the 700 W limit
FP32_OPS_PER_S = 67e12     # H100 SXM float32 outside the tensor cores
SLEEP_CYCLES = 100_000_000  # ~50 ms at the H100's 1.98 GHz boost clock


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(msg):
    print(f"[chip_smoke] {msg}", flush=True)


def cuda_ms(fn, iters=20, warmup=3):
    """Per call of ``fn``, the mean over ``iters`` calls of:

    - ``ms``: device milliseconds from CUDA events around calls queued
      behind a ~50 ms device sleep, so that the host's time to enqueue them
      leaves the card no gap: the device's own time;
    - ``host_us``: host microseconds to enqueue one of those calls;
    - ``ms_back_to_back``: CUDA events around calls made one after the other
      on an idle card, with no sleep: the larger of the device's and the
      host's time, as a caller that waits on each call sees it."""
    import torch
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    back_to_back = a.elapsed_time(b) / iters
    torch.cuda._sleep(SLEEP_CYCLES)
    a.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_us = (time.perf_counter() - t0) / iters * 1e6
    b.record()
    b.synchronize()
    return {"ms": a.elapsed_time(b) / iters, "ms_back_to_back": back_to_back,
            "host_us": host_us}


def write_clouds(root, n, img, n_points, seed0):
    """Seeded lane-structured clouds, written as LAS tiles."""
    import numpy as np
    from lanemapping_tpu_torch.data.las import write_las_points
    from lanemapping_tpu_torch.data.synthetic import (lane_structured_points,
                                                      random_lane_seqs)
    os.makedirs(os.path.join(root, "las"), exist_ok=True)
    for i in range(n):
        rng = np.random.RandomState(seed0 + i)
        seqs = random_lane_seqs(rng, img=img, n_lanes=5)
        sem = rng.randint(1, 3, len(seqs))
        pts = lane_structured_points(seqs, sem, img, rng, n_points)
        write_las_points(os.path.join(root, "las", f"tile{i:03d}.las"), pts)


def load_batch(root, names, n_points):
    import numpy as np
    from lanemapping_tpu_torch.data.las import load_lidar_points, pad_points
    bufs = [pad_points(load_lidar_points(os.path.join(root, "las",
                                                      n + ".las")), n_points)
            for n in names]
    return (np.stack([b[0] for b in bufs]), np.stack([b[1] for b in bufs]))


def phase_card():
    import torch
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    log(f"card {card}")
    print(card, flush=True)
    kind = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind} "
        f"count {torch.cuda.device_count()}")
    return card, kind


def reset_launches():
    from lanemapping_tpu_torch.kernels.bev_bin import bev_bin_mean
    from lanemapping_tpu_torch.kernels.voxel_bin import voxel_bin_mean
    bev_bin_mean.launches = voxel_bin_mean.launches = 0


def read_launches():
    from lanemapping_tpu_torch.kernels.bev_bin import bev_bin_mean
    from lanemapping_tpu_torch.kernels.voxel_bin import voxel_bin_mean
    return {"bev_bin_mean": bev_bin_mean.launches,
            "voxel_bin_mean": voxel_bin_mean.launches}


def time_in_turns(fns, iters=20):
    """``cuda_ms`` of each callable of {name: fn}, timed in the order
    a, b, ..., ..., b, a: {name: the mean of its two runs}, and every run."""
    order = list(fns) + list(fns)[::-1]
    runs = {k: [] for k in fns}
    for name in order:
        runs[name].append(cuda_ms(fns[name], iters=iters))
    return {k: {m: sum(r[m] for r in v) / len(v) for m in v[0]}
            for k, v in runs.items()}, runs


def fmt_times(t):
    return (f"{t['ms']:.4f} ms ({t['ms_back_to_back']:.4f} back to back, "
            f"host {t['host_us']:.1f} us/call)")


def profile_passes(fn, iters):
    """Device us per call of each pass of a binning wrapper, from
    ``torch.profiler``, and the host us per call under the profiler."""
    from lanemapping_tpu_torch.tools.profile_binning import (pass_split,
                                                             profile)
    kernels, host_us = profile(fn, iters)
    split = pass_split(kernels)
    check(all(split.get(k, 0.0) > 0 for k in ("hist", "scan", "scatter",
                                              "mean")),
          f"the profiler saw no device time of some pass: {kernels}")
    return split, host_us


def phase_build():
    from lanemapping_tpu_torch.kernels import build
    t0 = time.perf_counter()
    built = build.build_all(["bev_bin", "voxel_bin"], force=True)
    log(f"K1 + K1z build {time.perf_counter() - t0:.3f} s (nvcc "
        f"{' '.join(build.NVCC_FLAGS)})")
    for name, rec in built.items():
        log(f"{name}: nvcc {rec['seconds']:.3f} s; ptxas:\n{rec['ptxas']}")
    for name in ("bev_bin", "voxel_bin"):
        check(os.path.isfile(os.path.join(build.BUILD_DIR, f"lib{name}.so")),
              f"lib{name}.so missing after the build")


def phase_k1(root, pc_range):
    import numpy as np
    import torch
    from lanemapping_tpu_torch.kernels import bev_bin, bin_bands as bands
    pts_np, msk_np = load_batch(root, [f"tile{i:03d}" for i in range(B)],
                                N_POINTS)
    pts = torch.from_numpy(pts_np).cuda()
    msk = torch.from_numpy(msk_np).cuda()
    kw = dict(flip_rows=True)
    m, c = bev_bin.bev_bin_mean(pts, msk, pc_range, IMG, **kw)
    m_ref, c_ref = bev_bin.bev_bin_mean_ref(pts, msk, pc_range, IMG, **kw)
    torch.cuda.synchronize()
    cnt_mismatch = int((c != c_ref).sum())
    max_abs_err = float((m - m_ref).abs().max())
    mean_ok = bool(torch.allclose(m, m_ref, rtol=1e-5, atol=1e-5))
    n_valid = int(c_ref.sum())
    log(f"K1 vs plain: {n_valid} binned points, cnt_mismatch {cnt_mismatch}, "
        f"max_abs_err means {max_abs_err:.3e}, allclose {mean_ok}; occupied "
        f"cells {int((c_ref > 0).sum())}, most points in one cell "
        f"{int(c_ref.max())}")
    check(cnt_mismatch == 0, f"K1 counts differ in {cnt_mismatch} cells")
    check(mean_ok, f"K1 means differ: max abs err {max_abs_err}")

    # the library yardstick: one index_put_ of (value, 1) rows on indices
    # precomputed outside the timed call
    lo, size = bev_bin.bin_geometry(pc_range, IMG)
    q = (pts[..., :2] - torch.as_tensor(lo, device=pts.device)) \
        / torch.as_tensor(size, device=pts.device)
    valid = msk & ((q >= 0) & (q < IMG)).all(-1)
    ij = torch.where(valid[..., None], torch.floor(q),
                     torch.zeros((), device=pts.device)).long()
    tile = torch.arange(B, device=pts.device)[:, None]
    lin = ((tile * IMG + (IMG - 1 - ij[..., 1])) * IMG + ij[..., 0])
    lin = lin.reshape(-1)
    rows = torch.stack([torch.where(valid, pts[..., 3], 0.0),
                        valid.float()], -1).reshape(-1, 2)

    def library():
        return torch.zeros(B * IMG * IMG, 2, device=pts.device).index_put_(
            (lin,), rows, accumulate=True)

    lib = library().view(B, IMG, IMG, 2)
    check(torch.equal(lib[..., 1], c_ref), "index_put_ yardstick counts")
    def kernel():
        return bev_bin.bev_bin_mean(pts, msk, pc_range, IMG, **kw)

    t, runs = time_in_turns({
        "kernel": kernel,
        "plain": lambda: bev_bin.bev_bin_mean_ref(pts, msk, pc_range, IMG,
                                                  **kw),
        "library": library,
        "zeros_old_outputs": lambda: torch.zeros(2 * B * IMG * IMG,
                                                 device=pts.device)})
    # each input read once, each output (mean, count) written once
    n_bytes = pts.numel() * 4 + msk.numel() + 2 * B * IMG * IMG * 4
    n_ops = 6 * B * N_POINTS + 2 * n_valid + B * IMG * IMG
    bound_ms = max(n_bytes / HBM_BYTES_PER_S, n_ops / FP32_OPS_PER_S) * 1e3
    log(f"K1 kernel {fmt_times(t['kernel'])}, plain {fmt_times(t['plain'])}, "
        f"index_put_ {fmt_times(t['library'])}, bound {bound_ms:.4f} ms "
        f"({n_bytes / 1e6:.1f} MB at 3.35 TB/s); old outputs' zero fill "
        f"{fmt_times(t['zeros_old_outputs'])}; runs {runs}")

    plan = bands.band_plan(B, N_POINTS, IMG, IMG)
    pass_bytes = k_pass_bytes(pts, msk, n_valid, plan.rec,
                              2 * B * IMG * IMG * 4)
    pass_us, prof_host_us = profile_passes(kernel, 20)
    log(f"K1 passes (profiler, device us/call): " + ", ".join(
        f"{k} {v:.2f}" for k, v in pass_us.items())
        + f"; host {prof_host_us:.1f} us/call under the profiler; bytes "
        f"{pass_bytes}; plan {plan}")
    return {"name": "bev_bin_mean", "route": "cuda",
            "source": "lanemapping_tpu_torch/csrc/bev_bin.cu",
            "replaces": "tests/pallas_reference_bev.py:111",
            "launches": None, "max_abs_err": max_abs_err,
            "ms": t["kernel"]["ms"], "plain_ms": t["plain"]["ms"],
            "bound_ms": bound_ms, "bound_by": "bytes",
            "library_ms": t["library"]["ms"], "library": "index_put_",
            "ms_back_to_back": t["kernel"]["ms_back_to_back"],
            "host_us": t["kernel"]["host_us"],
            "zeros_old_outputs_ms": t["zeros_old_outputs"]["ms"],
            "passes_us": pass_us, "passes_bytes": pass_bytes,
            "cnt_mismatch": cnt_mismatch}


def k_pass_bytes(pts, msk, n_valid, rec, out_bytes):
    """Bytes each pass must move: (A) reads the points and the mask, (C)
    reads them again and writes one record of ``rec`` floats per binned
    point (padding not counted), (D) reads the records and writes the
    outputs."""
    inputs = pts.numel() * 4 + msk.numel()
    payload = n_valid * 4 * rec
    return {"hist": inputs, "scatter": inputs + payload,
            "mean": payload + out_bytes}


def phase_slice(root, out_dir):
    from lanemapping_tpu_torch.config.config import Config
    from lanemapping_tpu_torch.tools import stream_map

    reset_launches()
    rec = stream_map.main([FLAGSHIP, root, "--from-las", "--batch", str(B),
                           "--out", out_dir, "--seed", "0", "--bench-json"])
    counts = read_launches()
    launches = counts["bev_bin_mean"]
    log(f"slice: launches {counts}")
    check(launches > 0, "the main path never launched K1")
    check(rec["n_tiles"] == N_CLOUDS, f"{rec['n_tiles']} tiles streamed")
    names, n_lanes = check_lane_jsons(rec["lanes_dir"], N_CLOUDS)
    log(f"slice tiles/s {rec['value']:.4f} ({rec['n_tiles']} tiles, "
        f"{rec['n_batches']} batches of {rec['batch']}, "
        f"{rec['wall_s']:.4f} s, {rec['dtype']}); lanes {n_lanes}")
    for stage, ms in rec["stage_ms_per_batch"].items():
        log(f"slice stage {stage} ms/batch {ms:.4f}")

    check_flagship_head_maps(Config.fromfile(FLAGSHIP), root, names)
    log("slice head maps finite with the expected shapes")
    return launches, rec


def check_flagship_head_maps(cfg, root, names, extra=None):
    """Every head map of one batch of ``root``'s clouds through the modules
    of ``cfg`` (seeded weights, bf16): finite, of the expected shapes (the
    column head's, and ``extra`` {key: shape})."""
    import torch
    from lanemapping_tpu_torch.models.nets import build_model
    from lanemapping_tpu_torch.ops.voxelize import bev_image_from_points
    from lanemapping_tpu_torch.tools.las2bev import las2bev_params

    model = build_model(cfg, seed=0).to("cuda", torch.bfloat16)
    p = las2bev_params(cfg)
    pts, msk = load_batch(root, [n[:-5] for n in names[:B]], N_POINTS)
    with torch.inference_mode():
        x = bev_image_from_points(torch.from_numpy(pts).cuda(),
                                  torch.from_numpy(msk).cuda(), p["pc_range"],
                                  IMG, gain=p["gain"], bias=p["bias"],
                                  fill_iters=p["fill_iters"])
        out = model(x[..., None].expand(*x.shape, 3).to(torch.bfloat16))
    S, P = cfg.heads.row_size, cfg.heads.num_prop
    want = {**head_shapes(S, P), **(extra or {})}
    check(set(out) == set(want), f"head keys {sorted(out)}")
    for k, shape in want.items():
        check(tuple(out[k].shape) == shape, f"{k} shape {tuple(out[k].shape)}")
        check(bool(torch.isfinite(out[k]).all()), f"{k} is not finite")
    check(bool(torch.isfinite(x).all()), "BEV tile is not finite")


def phase_card_vs_cpu(root):
    import numpy as np
    import torch
    from lanemapping_tpu_torch.api import to_numpy
    from lanemapping_tpu_torch.config.config import Config
    from lanemapping_tpu_torch.decode.lane_decode import (decode_lanes,
                                                          host_decode_view)
    from lanemapping_tpu_torch.decode.postprocess import lane_maps_from_decode
    from lanemapping_tpu_torch.models.nets import build_model
    from lanemapping_tpu_torch.ops.voxelize import bev_image_from_points
    from lanemapping_tpu_torch.tools.export_lanes import lane_records
    from lanemapping_tpu_torch.tools.las2bev import las2bev_params

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    cfg = Config.fromfile(TINY)
    img = cfg.list_img_size_xy[0]
    write_clouds(root, 2, img, 1 << 16, seed0=100)
    pts, msk = load_batch(root, ["tile000", "tile001"], 1 << 16)
    p = las2bev_params(cfg)
    # weight seed 15 puts every decision the host makes on these clouds at
    # least 3.8e-3 from its threshold (proposal confidence, existence
    # class, column argmax, the tracker's cell and thinning comparisons;
    # measured on the CPU), far beyond float32 card-vs-CPU differences
    cpu_model = build_model(cfg, seed=15)
    gpu_model = copy.deepcopy(cpu_model).cuda()
    res = {}
    for dev, model in (("cpu", cpu_model), ("cuda", gpu_model)):
        with torch.inference_mode():
            x = bev_image_from_points(
                torch.from_numpy(pts).to(dev), torch.from_numpy(msk).to(dev),
                p["pc_range"], img, gain=p["gain"], bias=p["bias"],
                fill_iters=p["fill_iters"])
            out = model(x[..., None].expand(*x.shape, 3).contiguous())
            heads = {k: v.float().cpu().numpy() for k, v in out.items()}
            dec = to_numpy(host_decode_view(decode_lanes(out, cfg)))
        maps = lane_maps_from_decode(dec, cfg)
        res[dev] = (x.cpu().numpy(), heads,
                    [lane_records(m) for m in maps["cls_offset_smooth"]])
    (x_c, h_c, r_c), (x_g, h_g, r_g) = res["cpu"], res["cuda"]
    check(np.allclose(x_g, x_c, rtol=1e-5, atol=1e-6), "tiny BEV tiles differ")
    worst = 0.0
    for k in h_c:
        err = float(np.abs(h_g[k] - h_c[k]).max()
                    / max(1e-3, float(np.abs(h_c[k]).max())))
        log(f"tiny card vs cpu {k}: rel-max err {err:.3e}")
        check(err < 2e-3, f"tiny {k}: rel-max err {err:.3e} >= 2e-3")
        worst = max(worst, err)
    n = 0
    for g, c in zip(r_g, r_c):
        check([(r["lane_id"], r["seq_len"]) for r in g]
              == [(r["lane_id"], r["seq_len"]) for r in c],
              "tiny lane records differ between card and CPU")
        for rg, rc in zip(g, c):
            sg, sc = np.asarray(rg["seq"]), np.asarray(rc["seq"])
            check(np.array_equal(sg[:, [0, 2]], sc[:, [0, 2]]) and
                  np.allclose(sg[:, 1], sc[:, 1], atol=1e-3),
                  f"tiny lane {rg['lane_id']} vertices differ")
            n += 1
    log(f"tiny card vs cpu: worst rel-max {worst:.3e}; {n} lane records "
        f"identical (columns to 1e-3 px)")
    check(n > 0, "tiny comparison produced no lane records")


def load_lidar_batch(root, stems, n_points):
    """Padded clouds of a LaserLane root, as its dataset loads them."""
    import numpy as np
    from lanemapping_tpu_torch.data.las import load_lidar_points, pad_points
    bufs = [pad_points(load_lidar_points(os.path.join(root, "las",
                                                      s + ".las")), n_points)
            for s in stems]
    return (np.stack([b[0] for b in bufs]), np.stack([b[1] for b in bufs]))


def phase_k1z(root, stems, pc_range):
    import numpy as np
    import torch
    from lanemapping_tpu_torch.kernels import bin_bands as bands, voxel_bin
    pts_np, msk_np = load_lidar_batch(root, stems[:B], N_POINTS)
    pts = torch.from_numpy(pts_np).cuda()
    msk = torch.from_numpy(msk_np).cuda()
    C = pts.shape[-1]
    X, Y, Z = GRID
    m = voxel_bin.voxel_bin_mean(pts, msk, pc_range, GRID)
    m_ref = voxel_bin.voxel_bin_mean_ref(pts, msk, pc_range, GRID)
    _, c_ref = voxel_bin.voxel_bin_sums_ref(pts, msk, pc_range, GRID)
    torch.cuda.synchronize()
    max_abs_err = float((m - m_ref).abs().max())
    mean_ok = bool(torch.allclose(m, m_ref, rtol=1e-5, atol=1e-5))
    # a voxel the kernel left empty, or filled where the plain version did
    # not, shows as a mean of exactly 0 against a non-zero one
    occ_mismatch = int(((m.view(B, Y, X, Z, C) != 0).any(-1)
                        != (m_ref.view(B, Y, X, Z, C) != 0).any(-1)).sum())
    n_valid = int(c_ref.sum())
    log(f"K1z vs plain: {n_valid} binned points, max_abs_err means "
        f"{max_abs_err:.3e}, allclose {mean_ok}, occupancy mismatch "
        f"{occ_mismatch}; occupied voxels {int((c_ref > 0).sum())}, most "
        f"points in one voxel {int(c_ref.max())}")
    check(mean_ok, f"K1z means differ: max abs err {max_abs_err}")
    check(occ_mismatch == 0, f"K1z occupancy differs in {occ_mismatch}")
    check(n_valid > 0, "K1z binned no point")

    # the library yardsticks on voxel indices precomputed outside the timed
    # call: one index_reduce_ to the mean of the valid points' rows (the
    # same function), and one index_put_ of (features, 1) rows
    ijk, valid = voxel_bin.voxel_cells(pts, pc_range, GRID)
    valid = valid & msk
    tile = torch.arange(B, device=pts.device)[:, None]
    lin = (((tile * Y + ijk[..., 1]) * X + ijk[..., 0]) * Z + ijk[..., 2])
    lin_v, feats_v = lin[valid], pts[valid]
    lin = torch.where(valid, lin, 0).reshape(-1)
    rows = torch.cat([torch.where(valid[..., None], pts, 0.0),
                      valid[..., None].float()], -1).reshape(-1, C + 1)

    def library():
        return torch.zeros(B * Y * X * Z, C, device=pts.device).index_reduce_(
            0, lin_v, feats_v, "mean", include_self=False)

    def index_put():
        return torch.zeros(B * Y * X * Z, C + 1,
                           device=pts.device).index_put_(
            (lin,), rows, accumulate=True)

    check(bool(torch.allclose(library().view(B, Y, X, Z * C), m_ref,
                              rtol=1e-5, atol=1e-5)),
          "index_reduce_ yardstick means")
    check(torch.equal(index_put().view(B, Y, X, Z, C + 1)[..., C], c_ref),
          "index_put_ yardstick counts")
    def kernel():
        return voxel_bin.voxel_bin_mean(pts, msk, pc_range, GRID)

    t, runs = time_in_turns({
        "kernel": kernel,
        "plain": lambda: voxel_bin.voxel_bin_mean_ref(pts, msk, pc_range,
                                                      GRID),
        "library": library, "index_put": index_put,
        "zeros_old_outputs": lambda: torch.zeros(B * Y * X * Z * (C + 1),
                                                 device=pts.device)},
        iters=10)
    # each input read once, the mean written once
    n_bytes = pts.numel() * 4 + msk.numel() + m.numel() * 4
    # 3 sub + 3 div per point, C + 1 adds per binned point, one division
    # per output
    n_ops = 6 * B * N_POINTS + (C + 1) * n_valid + m.numel()
    bound_ms = max(n_bytes / HBM_BYTES_PER_S, n_ops / FP32_OPS_PER_S) * 1e3
    log(f"K1z kernel {fmt_times(t['kernel'])}, plain "
        f"{fmt_times(t['plain'])}, index_reduce_ {fmt_times(t['library'])}, "
        f"index_put_ {fmt_times(t['index_put'])}, bound {bound_ms:.4f} ms "
        f"({n_bytes / 1e6:.1f} MB at 3.35 TB/s); old outputs' zero fill "
        f"{fmt_times(t['zeros_old_outputs'])}; runs {runs}")

    plan = bands.band_plan(B, N_POINTS, Y, X, Z, C,
                           voxel_bin.record_floats(C))
    pass_bytes = k_pass_bytes(pts, msk, n_valid, plan.rec, m.numel() * 4)
    pass_us, prof_host_us = profile_passes(kernel, 10)
    log(f"K1z passes (profiler, device us/call): " + ", ".join(
        f"{k} {v:.2f}" for k, v in pass_us.items())
        + f"; host {prof_host_us:.1f} us/call under the profiler; bytes "
        f"{pass_bytes}; plan {plan}")
    return {"name": "voxel_bin_mean", "route": "cuda",
            "source": "lanemapping_tpu_torch/csrc/voxel_bin.cu",
            "replaces": "tests/pallas_reference_bev.py:171",
            "launches": None, "max_abs_err": max_abs_err,
            "ms": t["kernel"]["ms"], "plain_ms": t["plain"]["ms"],
            "bound_ms": bound_ms, "bound_by": "bytes",
            "library_ms": t["library"]["ms"], "library": "index_reduce_",
            "index_put_ms": t["index_put"]["ms"],
            "ms_back_to_back": t["kernel"]["ms_back_to_back"],
            "host_us": t["kernel"]["host_us"],
            "zeros_old_outputs_ms": t["zeros_old_outputs"]["ms"],
            "passes_us": pass_us, "passes_bytes": pass_bytes}


def head_shapes(S, P):
    """The raw head maps of a batch of B full-width tiles."""
    return {"semantic_seg": (B, IMG, IMG, 3), "endp_est": (B, IMG, IMG, 1),
            "orient": (B, S, S, 11), "proposal_conf": (B, P, 2),
            "ext2": (B, P, S, 3), "cls2": (B, P, S, 10),
            "offset2": (B, P, S, 10), "prop_seg_small": (B, P, 2 * S, 20)}


LANE_RECORD_KEYS = {"lane_id", "seq_len", "init_vertex", "end_vertex", "seq"}


def check_lane_jsons(lanes_dir, n_tiles):
    """One lane JSON per tile, each record with the record schema and
    finite vertices; (file names, lane count)."""
    import numpy as np
    names = sorted(os.listdir(lanes_dir))
    check(len(names) == n_tiles, f"{len(names)} lane JSONs written")
    n_lanes = 0
    for n in names:
        with open(os.path.join(lanes_dir, n)) as f:
            recs = json.load(f)
        for r in recs:
            check(LANE_RECORD_KEYS <= set(r), f"{n}: record keys {sorted(r)}")
            seq = np.asarray(r["seq"], np.float64)
            check(np.isfinite(seq).all(), f"{n}: non-finite lane vertex")
            check(r["seq_len"] == len(seq), f"{n}: seq_len {r['seq_len']}")
        n_lanes += len(recs)
    return names, n_lanes


def phase_lidar_slice(root, stems, out_dir):
    import torch
    from lanemapping_tpu_torch.config.config import Config
    from lanemapping_tpu_torch.models.nets import (
        build_model, round_weights_as_flax_promotes)
    from lanemapping_tpu_torch.tools import stream_map

    reset_launches()
    rec = stream_map.main([LIDAR, root, "--split", "infer_only", "--batch",
                           str(B), "--out", out_dir, "--seed", "0",
                           "--bench-json"])
    counts = read_launches()
    launches = counts["voxel_bin_mean"]
    log(f"lidar slice: launches {counts}")
    check(launches > 0, "the LiDAR path never launched K1z")
    check(rec["n_tiles"] == len(stems), f"{rec['n_tiles']} tiles streamed")
    _, n_lanes = check_lane_jsons(rec["lanes_dir"], len(stems))
    log(f"lidar slice tiles/s {rec['value']:.4f} ({rec['n_tiles']} tiles, "
        f"{rec['n_batches']} batches of {rec['batch']}, "
        f"{rec['wall_s']:.4f} s, {rec['dtype']}, "
        f"{rec['points_per_tile']} points per tile); lanes {n_lanes}")
    for stage, ms in rec["stage_ms_per_batch"].items():
        log(f"lidar slice stage {stage} ms/batch {ms:.4f}")

    # every head map of one batch through the same modules: finite, shaped
    cfg = Config.fromfile(LIDAR)
    model = round_weights_as_flax_promotes(build_model(cfg, seed=0))
    model = model.to("cuda").to(memory_format=torch.channels_last)
    pts, msk = load_lidar_batch(root, stems[:B], N_POINTS)
    with torch.inference_mode():
        out = model({"points": torch.from_numpy(pts).cuda(),
                     "points_mask": torch.from_numpy(msk).cuda()})
    S, P = cfg.heads.row_size, cfg.heads.num_prop
    want = head_shapes(S, P)
    check(set(out) == set(want), f"head keys {sorted(out)}")
    for k, shape in want.items():
        check(tuple(out[k].shape) == shape, f"{k} shape {tuple(out[k].shape)}")
        check(out[k].dtype == torch.float32, f"{k} dtype {out[k].dtype}")
        check(bool(torch.isfinite(out[k]).all()), f"{k} is not finite")
    log("lidar slice head maps finite with the expected shapes")
    return launches, rec


def phase_lidar_card_vs_cpu(root):
    import numpy as np
    import torch
    from lanemapping_tpu_torch.api import to_numpy
    from lanemapping_tpu_torch.config.config import Config
    from lanemapping_tpu_torch.data.synthetic import generate_dataset
    from lanemapping_tpu_torch.decode.lane_decode import (decode_lanes,
                                                          host_decode_view)
    from lanemapping_tpu_torch.decode.postprocess import lane_maps_from_decode
    from lanemapping_tpu_torch.models.nets import build_model
    from lanemapping_tpu_torch.ops.voxelize import voxelize_bev_zfold
    from lanemapping_tpu_torch.tools.export_lanes import lane_records

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    cfg = Config.fromfile(TINY_LIDAR)
    stems = generate_dataset(root, n_tiles=2, img=192, seed=11,
                             with_points=True, points_per_tile=4096)
    pts, msk = load_lidar_batch(root, stems, cfg.max_points)
    grid = tuple(cfg.grid_size)
    pc_range = cfg.lidar_point_cloud_range
    # weight seed 2 puts every decision the host makes on these clouds at
    # least 3.7e-3 from its threshold (proposal confidence, column argmax,
    # the tracker's cell; measured on the CPU), far beyond float32
    # card-vs-CPU differences
    cpu_model = build_model(cfg, seed=2)
    gpu_model = copy.deepcopy(cpu_model).cuda()
    res = {}
    for dev, model in (("cpu", cpu_model), ("cuda", gpu_model)):
        p, m = torch.from_numpy(pts).to(dev), torch.from_numpy(msk).to(dev)
        with torch.inference_mode():
            vox = voxelize_bev_zfold(p, m, pc_range, grid)
            out = model({"points": p, "points_mask": m})
            heads = {k: v.float().cpu().numpy() for k, v in out.items()}
            dec = to_numpy(host_decode_view(decode_lanes(out, cfg)))
        maps = lane_maps_from_decode(dec, cfg)
        res[dev] = (vox.cpu().numpy(), heads,
                    [lane_records(r) for r in maps["cls_offset_smooth"]])
    (v_c, h_c, r_c), (v_g, h_g, r_g) = res["cpu"], res["cuda"]
    check(np.allclose(v_g, v_c, rtol=1e-5, atol=1e-6),
          "tiny LiDAR z-fold planes differ")
    worst = 0.0
    for k in h_c:
        err = float(np.abs(h_g[k] - h_c[k]).max()
                    / max(1e-3, float(np.abs(h_c[k]).max())))
        log(f"tiny lidar card vs cpu {k}: rel-max err {err:.3e}")
        check(err < 2e-3, f"tiny lidar {k}: rel-max err {err:.3e} >= 2e-3")
        worst = max(worst, err)
    n = 0
    for g, c in zip(r_g, r_c):
        check([(r["lane_id"], r["seq_len"]) for r in g]
              == [(r["lane_id"], r["seq_len"]) for r in c],
              "tiny lidar lane records differ between card and CPU")
        for rg, rc in zip(g, c):
            sg, sc = np.asarray(rg["seq"]), np.asarray(rc["seq"])
            check(np.array_equal(sg[:, [0, 2]], sc[:, [0, 2]]) and
                  np.allclose(sg[:, 1], sc[:, 1], atol=1e-3),
                  f"tiny lidar lane {rg['lane_id']} vertices differ")
            n += 1
    log(f"tiny lidar card vs cpu: worst rel-max {worst:.3e}; {n} lane "
        f"records identical (columns to 1e-3 px)")
    check(n > 0, "tiny LiDAR comparison produced no lane records")


TERMS = ("proposal_loss", "ext_loss2", "cls_loss2", "cls_mean_loss2",
         "cls_smooth_loss2", "endp_loss", "orient_loss", "binary_seg_loss",
         "offset_loss", "semantic_seg_loss")


def torch_defaults():
    """PyTorch's default precision flags (phases 5 and 8 turn TF32 off)."""
    import torch
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = False


def train_cfg(path, root, **over):
    """A config with every split at ``root`` and top-level ``over``."""
    from lanemapping_tpu_torch.config.config import Config
    cfg = Config.fromfile(path)
    for split in ("train", "val", "test"):
        cfg.dataset[split]["data_root"] = root
    for k, v in over.items():
        cfg[k] = v
    return cfg


def train_records(log_dir):
    with open(os.path.join(log_dir, "train.jsonl")) as f:
        return [json.loads(line) for line in f]


def snapshot(state):
    """A deep copy of a train state, as state dicts."""
    return copy.deepcopy({
        "model": state.model.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "scheduler": state.scheduler.state_dict(), "step": state.step,
        "generator": state.generator.get_state()})


def same_state(a, b):
    """Whether two snapshots are bit-identical; the first difference."""
    import torch
    if a["step"] != b["step"]:
        return False, "step"
    if a["scheduler"] != b["scheduler"]:
        return False, "scheduler"
    if not torch.equal(a["generator"], b["generator"]):
        return False, "generator"
    for k, v in a["model"].items():
        if not torch.equal(v, b["model"][k]):
            return False, k
    oa, ob = a["optimizer"], b["optimizer"]
    if oa["param_groups"] != ob["param_groups"] or \
            oa["state"].keys() != ob["state"].keys():
        return False, "optimizer groups"
    for i, st in oa["state"].items():
        for k, v in st.items():
            if not torch.equal(v, ob["state"][i][k]):
                return False, f"optimizer state {i}.{k}"
    return True, None


def time_loss_parts(db, out_shapes, hp):
    """Forward + backward ms of three loss parts at a train step's shapes
    and dtypes, on the step's labels and seeded logits: the fused
    per-proposal seg focal, the full-resolution semantic CE and the
    full-resolution endpoint focal (``cuda_ms``)."""
    import torch
    from lanemapping_tpu_torch.models.head_losses import (
        _fused_prop_seg_focal, _heatmap_f32)
    from lanemapping_tpu_torch.ops.losses import (
        cross_entropy_with_int_labels, sigmoid_focal_loss)
    dev = db["prop_ext"].device
    g = torch.Generator(device=dev).manual_seed(0)
    x = {k: torch.randn(s, generator=g, device=dev).to(dt)
         .requires_grad_() for k, (s, dt) in out_shapes.items()}
    W = hp["prop_fea_width"]
    ext, coor = db["prop_ext"].float(), db["prop_coor"].float()
    pos = torch.where((coor >= W) | (coor < 0) | (ext == 0), 0.0,
                      ext).sum(2) > 2.0
    lb = _heatmap_f32(db["endp_map"])
    w = torch.where(lb > 1e-12, lb * 4.0, 0.5)
    tgt = (lb > 1e-12).float()

    def seg():
        _fused_prop_seg_focal(x["prop_seg_small"], db["prop_inst"],
                              db["prop_best"], pos, hp).backward()

    def ce():
        cross_entropy_with_int_labels(
            x["semantic_seg"], db["semantic_label_raw"].long()
        ).sum().backward()

    def endp():
        (w * sigmoid_focal_loss(x["endp_est"][..., 0].float(), tgt)
         ).sum().backward()

    return {k: cuda_ms(f, iters=5, warmup=1)["ms"]
            for k, f in (("seg_focal", seg), ("semantic_ce", ce),
                         ("endp_focal", endp))}


def profile_step(runner, db, top=12):
    """One train step under ``torch.profiler``: the step's device ms (the
    sum over its kernels), the ops with the most device time of their own
    (ms, calls), and the share of the convolutions (forward and
    backward)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        runner.train_step(runner.state, db)
        torch.cuda.synchronize()
    ops, device_ms = [], 0.0
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        if ev.device_type == DeviceType.CUDA:
            device_ms += us / 1e3  # a kernel
        elif us > 0:
            ops.append((us / 1e3, ev.key[:60], ev.count))  # an op
    ops.sort(reverse=True)
    conv_ms = sum(ms for ms, k, _ in ops if "convolution" in k)
    return ops[:top], device_ms, conv_ms


def phase_train(name, config, root, log_dir, n_steps, lidar):
    """``Runner.train`` at full width on the card (phases 9 and 10), then
    its numbers, a profiled step, a checkpoint resume and a validate
    pass.  Returns the launch counts of the training run."""
    import torch
    from lanemapping_tpu_torch.data.loader import build_dataloader
    from lanemapping_tpu_torch.engine.checkpoint import save_model
    from lanemapping_tpu_torch.engine.runner import Runner
    from lanemapping_tpu_torch.models.head_losses import head_hparams

    torch_defaults()
    # log every step; no validate or save inside the timed run; the
    # proposal-GT cache makes passes after the first load from disk
    cfg = train_cfg(config, root, log_every=1, eval_ep=10 ** 6,
                    save_ep=10 ** 6, gt_cache=True, workers=8)
    runner = Runner(cfg, log_dir=log_dir)
    check(runner.device.type == "cuda", f"{name}: runner on {runner.device}")
    step, times = runner.train_step, []

    def timed_step(state, batch):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        stats = step(state, batch)  # reads the loss on the host
        b.record()
        times.append((a, b, time.perf_counter() - t0))
        return stats

    if lidar:
        seen = {}
        runner.model.pcencoder.zfold_encoder.register_forward_pre_hook(
            lambda mod, inp: seen.update(vox=(inp[0].grad_fn,
                                              inp[0].requires_grad)))
    runner.train_step = timed_step
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    runner.train(max_iters=n_steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    runner.train_step = step
    if lidar:
        check(seen["vox"] == (None, False),
              f"{name}: the voxelized plane is not an autograd leaf")
        check(launches["voxel_bin_mean"] > 0,
              f"{name}: the training path never launched K1z")

    recs = train_records(log_dir)
    check(len(recs) == n_steps, f"{name}: {len(recs)} steps logged")
    for r in recs:
        bad = [k for k in TERMS + ("loss",) if not math.isfinite(r[k])]
        check(not bad, f"{name}: non-finite {bad} at step {r['iter']}")
        check(r["skipped_nan"] == 0.0, f"{name}: NaN guard fired")
    per_epoch = {}
    for r in recs:
        per_epoch.setdefault(r["epoch"], []).append(r["loss"])
    first, last = (sum(v) / len(v) for v in (per_epoch[min(per_epoch)],
                                             per_epoch[max(per_epoch)]))
    check(len(per_epoch) > 1 and last < first,
          f"{name}: loss of the last pass {last} not below the first "
          f"{first}")
    step_ms = [a.elapsed_time(b) for a, b, _ in times]
    host_s = [h for _, _, h in times]
    s_step = sum(step_ms[1:]) / len(step_ms[1:]) / 1e3
    median = sorted(step_ms[1:])[len(step_ms[1:]) // 2] / 1e3
    B = cfg.batch_size
    log(f"{name}: {n_steps} steps of batch {B} via Runner.train in "
        f"{wall:.3f} s ({n_steps * B / wall:.4f} tiles/s with loading); "
        f"per step (CUDA events) ms {[round(t, 4) for t in step_ms]}, host "
        f"s {[round(h, 4) for h in host_s]}; after the warm-up step "
        f"{s_step:.5f} s/step (median {median:.5f}), {B / s_step:.4f} "
        f"tiles/s; peak "
        f"max_memory_allocated {peak / 2 ** 30:.3f} GiB; launches "
        f"{launches}")
    log(f"{name}: losses per step {[round(r['loss'], 5) for r in recs]}; "
        f"first pass {first:.5f}, last pass {last:.5f}")
    log(f"{name}: terms of the last step " + ", ".join(
        f"{k} {recs[-1][k]:.5f}" for k in TERMS))

    # one more step under the profiler, and the loss parts at its shapes
    batch = next(iter(build_dataloader(cfg.dataset.train, cfg)))
    db = runner._device_batch(batch)
    rows, total_ms, conv_ms = profile_step(runner, db)
    log(f"{name}: profiled step, device ms {total_ms:.3f} (kernels), "
        f"convolutions {conv_ms:.3f} ms ({conv_ms / total_ms:.1%}); top ops "
        f"by own device time: " + "; ".join(
            f"{k} {ms:.3f} ms ({ms / total_ms:.1%}, x{n})"
            for ms, k, n in rows))
    S, P = cfg.heads.row_size, cfg.heads.num_prop
    W = cfg.heads.prop_width + 2 * cfg.heads.prop_half_buff
    cdt = torch.bfloat16 if cfg.get("train_compute_dtype") == "bfloat16" \
        and not lidar else torch.float32
    img = 8 * S
    parts = time_loss_parts(db, {
        "prop_seg_small": ((B, P, 2 * S, 2 * W), cdt),
        "semantic_seg": ((B, img, img, 3), cdt),
        "endp_est": ((B, img, img, 1), cdt)}, head_hparams(cfg))
    log(f"{name}: loss parts forward+backward (CUDA events, ms; share of "
        f"the {s_step * 1e3:.3f} ms step): " + ", ".join(
            f"{k} {ms:.4f} ({ms / (s_step * 1e3):.1%})"
            for k, ms in parts.items()))

    # checkpoint, a new Runner, resume: bit-identical
    save_model(log_dir, runner.state, "epoch_1")
    saved = snapshot(runner.state)
    fresh = Runner(cfg, log_dir=log_dir)
    check(fresh.resume_latest(), f"{name}: resume_latest found nothing")
    ok, where = same_state(snapshot(fresh.state), saved)
    check(ok, f"{name}: resumed state differs at {where}")
    log(f"{name}: epoch_1 saved and resumed bit-identical (step "
        f"{fresh.state.step}, lr "
        f"{fresh.state.optimizer.param_groups[0]['lr']:.6e})")
    del fresh

    t0 = time.perf_counter()
    metrics = runner.validate()
    log(f"{name}: validate on the valid split in "
        f"{time.perf_counter() - t0:.3f} s: {metrics}")
    return {"launches": launches, "s_per_step": s_step,
            "tiles_per_s": B / s_step, "peak_bytes": peak,
            "loss_parts_ms": parts}


def seed_adam(state, grads, seed, count=10):
    """Set a train state's Adam to a seeded mid-training state at update
    ``count``: per parameter, with s the RMS of its gradient in ``grads``
    floored at 1e-3 of the largest, bias-corrected moments v ~ s^2 U(0.5,
    2) and m ~ N(0, (0.3 s)^2) (as `tests/torch_port_helpers.py::
    mid_training_adam`), the same numbers whatever the device."""
    import numpy as np
    import torch
    rng = np.random.RandomState(seed)
    rms = [float(g.double().pow(2).mean().sqrt()) if g is not None else 0.0
           for g in grads]
    floor = 1e-3 * max(rms)
    c1, c2 = 1.0 - 0.9 ** count, 1.0 - 0.999 ** count
    for p, r in zip(state.model.parameters(), rms):
        s = max(r, floor)
        st = state.optimizer.state[p]
        st["step"] = torch.tensor(float(count))
        st["exp_avg"] = torch.from_numpy(
            (rng.normal(0.0, 0.3 * s, p.shape) * c1).astype("float32")
        ).to(p.device)
        st["exp_avg_sq"] = torch.from_numpy(
            (s * s * rng.uniform(0.5, 2.0, p.shape) * c2).astype("float32")
        ).to(p.device)
    sched = state.scheduler
    sched.last_epoch = count
    lrs = [b * f(count) for b, f in zip(sched.base_lrs, sched.lr_lambdas)]
    for group, lr in zip(state.optimizer.param_groups, lrs):
        group["lr"] = lr
    sched._last_lr = lrs


def phase_train_card_vs_cpu(root, log_dir):
    """Three train steps of the port on the card against the port on the
    CPU at both tiny configs, float32, TF32 off, from the same weights,
    Adam state and batch (phase 11)."""
    import numpy as np
    import torch
    from lanemapping_tpu_torch.data.loader import build_dataloader
    from lanemapping_tpu_torch.data.synthetic import generate_dataset
    from lanemapping_tpu_torch.engine.runner import Runner
    from lanemapping_tpu_torch.engine.state import model_input

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    generate_dataset(root, n_tiles=4, img=192, seed=3, with_points=True,
                     points_per_tile=4096)
    for config in (TINY, TINY_LIDAR):
        name = os.path.basename(config)
        # a tenth of the config's lr, as the CPU parity tests take it: the
        # float32 gradient of the image encoder is ill-conditioned at
        # random weights, and larger steps part any two float32 runs
        cfg = train_cfg(config, root)
        cfg.optimizer.lr = cfg.optimizer.lr / 10
        cfg.scheduler.T_max = 1000
        batch = next(iter(build_dataloader(cfg.dataset.train, cfg)))
        runners = {d: Runner(cfg, log_dir=os.path.join(log_dir, d, name),
                             device=d) for d in ("cpu", "cuda")}
        probe = copy.deepcopy(runners["cpu"].model).train()
        db = runners["cpu"]._device_batch(batch)
        loss = runners["cpu"]._loss_fn(
            probe(model_input(db, bool(cfg.get("use_lidar")))), db)["loss"]
        grads = torch.autograd.grad(loss, list(probe.parameters()),
                                    allow_unused=True)
        stats = {}
        for d, r in runners.items():
            seed_adam(r.state, grads, seed=1)
            stats[d] = [r.train_step(r.state, r._device_batch(batch))
                        for _ in range(3)]
        worst_loss = 0.0
        for i, (sc, sg) in enumerate(zip(stats["cpu"], stats["cuda"])):
            for k in TERMS + ("loss",):
                c, g = float(sc[k]), float(sg[k])
                err = abs(g - c) / max(abs(c), 1e-12) if c or g else 0.0
                check(err < 1e-4, f"tiny {name} step {i} {k}: card {g} cpu "
                      f"{c} (rel {err:.3e})")
                worst_loss = max(worst_loss, err)
        sd_c = runners["cpu"].model.state_dict()
        sd_g = runners["cuda"].model.state_dict()
        worst = (-1.0, "")
        for k, c in sd_c.items():
            if k.endswith("num_batches_tracked"):
                continue
            c = c.float().numpy()
            g = sd_g[k].float().cpu().numpy()
            err = float(np.abs(g - c).max() / max(1e-3, np.abs(c).max()))
            worst = max(worst, (err, k))
        check(worst[0] < 2e-3, f"tiny {name}: {worst[1]} rel-max "
              f"{worst[0]:.3e} >= 2e-3 after 3 steps")
        log(f"tiny {name} training card vs cpu: losses per step cpu "
            f"{[round(float(s['loss']), 6) for s in stats['cpu']]} card "
            f"{[round(float(s['loss']), 6) for s in stats['cuda']]}, worst "
            f"term rel {worst_loss:.3e}; parameters and BatchNorm buffers "
            f"worst rel-max {worst[0]:.3e} ({worst[1]})")


def zoo_cfg(name, root, **over):
    return train_cfg(os.path.join(HERE, "configs", ZOO[name][0]), root,
                     **over)


def zoo_shapes(name, cfg):
    """The raw outputs of a batch of B full-width tiles."""
    S, N = IMG // 8, cfg.number_lanes
    enc = {"semantic_seg": (B, IMG, IMG, 3), "endp_est": (B, IMG, IMG, 1)}
    if name == "rowref":
        return {**enc, "ext": (B, N, S, 2), "cls": (B, N, S, S),
                "ext2": (B, N, S, 2), "cls2": (B, N, S, S)}
    if name == "gridseg":
        return {"conf": (B, S, S), "cls": (B, S, S, cfg.heads.num_classes)}
    if name == "fpnseg":
        return enc
    return head_shapes(S, cfg.heads.num_prop)


class ForwardDecodeClock:
    """CUDA events per batch around a Runner's forward (hooks on its
    model) and around its device method (forward + decode), which it
    wraps: device ms of the forward and of the decode after it."""

    def __init__(self, runner, method):
        import torch
        self.events = []

        def mark():
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e

        runner.model.register_forward_pre_hook(
            lambda mod, inp: self.events.append([mark()]))
        runner.model.register_forward_hook(
            lambda mod, inp, out: self.events[-1].append(mark()))
        inner = getattr(runner, method)

        def timed(batch):
            out = inner(batch)
            self.events[-1].append(mark())
            return out
        setattr(runner, method, timed)

    def ms(self):
        """(forward ms, decode ms) per batch; clears the record."""
        import torch
        torch.cuda.synchronize()
        fwd = [a.elapsed_time(b) for a, b, _ in self.events]
        dec = [b.elapsed_time(c) for _, b, c in self.events]
        self.events = []
        return fwd, dec


def phase_zoo_serving(root, out_root):
    """Phase 12: validate and export each of the four configs at full
    width.  Returns {config: launch counts}."""
    import numpy as np
    import torch
    from lanemapping_tpu_torch.data.loader import build_dataloader
    from lanemapping_tpu_torch.engine.runner import KLANE_HEADS, Runner
    from lanemapping_tpu_torch.engine.state import eval_step

    torch_defaults()
    metric_keys = {"rowref": {"conf_f1", "composite"},
                   "gridseg": {"conf_f1", "composite"},
                   "fpnseg": {"seg_f1", "endp_f1", "composite"},
                   "mixseg": {"coor_f1", "endp_f1", "composite",
                              "semantic_f1"}}
    launches = {}
    for name in ZOO:
        # no gt_cache: the training phases' cached samples (train mode)
        # lack the labels validation reads (the cache is keyed without the
        # split's mode, in both packages)
        cfg = zoo_cfg(name, root, batch_size=B, workers=8)
        runner = Runner(cfg, log_dir=os.path.join(out_root, name, "log"))
        check(runner.device.type == "cuda", f"{name}: on {runner.device}")
        segmentor = cfg.net.type == "Segmentor"
        method = "_eval_seg" if segmentor else (
            "_eval_grid" if runner.head_type in KLANE_HEADS
            else "_eval_decode")
        clock = ForwardDecodeClock(runner, method)
        # every tile of phase 7's dataset, with its labels
        split = dict(cfg.dataset.val, mode="pretrain")

        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = runner.validate(
            loader=build_dataloader(split, cfg, is_train=False))
        wall = time.perf_counter() - t0
        fwd, dec = clock.ms()
        check(len(fwd) == N_CLOUDS // B, f"{name}: {len(fwd)} batches")
        check(metric_keys[name] <= set(metrics) and all(
            math.isfinite(v) for v in metrics.values()),
            f"{name}: validate metrics {metrics}")
        f_ms, d_ms = (sum(v) / len(v) for v in (fwd, dec))
        log(f"{name} validate: {N_CLOUDS} tiles in {wall:.3f} s "
            f"({N_CLOUDS / wall:.4f} tiles/s), batch {B}; device ms per "
            f"batch forward {f_ms:.4f} (each {[round(v, 4) for v in fwd]}),"
            f" decode {d_ms:.4f}; host ms per batch of the rest "
            f"{wall * 1e3 / len(fwd) - f_ms - d_ms:.4f}; metrics {metrics}")

        out_dir = os.path.join(out_root, name, "export")
        loader = build_dataloader(split, cfg, is_train=False)
        t0 = time.perf_counter()
        if segmentor:
            m = runner.infer_segmentor_and_export(loader, out_dir,
                                                  max_batches=1)
            check({"coor_conf_f1", "semantic_conf_f1"} <= set(m)
                  and all(math.isfinite(v) for v in m.values()),
                  f"{name}: segmentor metrics {m}")
            what = f"metrics {m}"
        else:
            if runner.head_type in KLANE_HEADS:
                runner.infer_grid_and_export(loader, out_dir, max_batches=1)
            else:
                runner.infer_and_export(loader, out_dir, max_batches=1)
            _, n_lanes = check_lane_jsons(out_dir, B)
            what = f"{B} lane JSONs, {n_lanes} lanes"
        wall = time.perf_counter() - t0
        fwd, dec = clock.ms()
        launches[name] = read_launches()
        log(f"{name} export: {what} in {wall:.3f} s; device ms forward "
            f"{fwd[0]:.4f}, decode {dec[0]:.4f}; host ms of the rest "
            f"{wall * 1e3 - fwd[0] - dec[0]:.4f}; launches "
            f"{launches[name]}")

        batch = next(iter(build_dataloader(split, cfg, is_train=False)))
        out = eval_step(runner.model, runner._eval_input(batch))
        want = zoo_shapes(name, cfg)
        check(set(out) == set(want), f"{name}: output keys {sorted(out)}")
        for k, shape in want.items():
            check(tuple(out[k].shape) == shape,
                  f"{name} {k} shape {tuple(out[k].shape)}")
            check(out[k].dtype == torch.float32, f"{name} {k} {out[k].dtype}")
            check(bool(torch.isfinite(out[k]).all()),
                  f"{name} {k} is not finite")
        log(f"{name}: outputs finite with the expected shapes")
        del runner, out
        torch.cuda.empty_cache()
    return launches


def phase_zoo_train(root, log_root):
    """Phase 13: three steps of each of the four configs at full width.
    Returns {config: launch counts}."""
    import torch
    from lanemapping_tpu_torch.data.loader import build_dataloader
    from lanemapping_tpu_torch.engine.runner import Runner

    torch_defaults()
    launches = {}
    for name, (_, batch) in ZOO.items():
        log_dir = os.path.join(log_root, name)
        cfg = zoo_cfg(name, root, log_every=1, eval_ep=10 ** 6,
                      save_ep=10 ** 6, gt_cache=True, workers=8)
        check(cfg.batch_size == batch, f"{name}: batch {cfg.batch_size}")
        runner = Runner(cfg, log_dir=log_dir)
        step, times = runner.train_step, []

        def timed_step(state, b, step=step):
            a = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            a.record()
            stats = step(state, b)  # reads the loss on the host
            e.record()
            times.append((a, e))
            return stats

        runner.train_step = timed_step
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        runner.train(max_iters=3)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches[name] = read_launches()
        peak = torch.cuda.max_memory_allocated()
        runner.train_step = step

        recs = train_records(log_dir)
        check(len(recs) == 3, f"{name}: {len(recs)} steps logged")
        terms = sorted(k for k in recs[0]
                       if k not in ("epoch", "iter", "skipped_nan"))
        for r in recs:
            bad = [k for k in terms if not math.isfinite(r[k])]
            check(not bad, f"{name}: non-finite {bad} at step {r['iter']}")
            check(r["skipped_nan"] == 0.0, f"{name}: NaN guard fired")
        step_ms = [a.elapsed_time(e) for a, e in times]
        s_step = sum(step_ms[1:]) / len(step_ms[1:]) / 1e3
        dtype = cfg.get("train_compute_dtype") or "float32"
        log(f"{name} training: 3 steps of batch {batch} ({dtype}) via "
            f"Runner.train in {wall:.3f} s; per step (CUDA events) ms "
            f"{[round(t, 4) for t in step_ms]}; after the warm-up step "
            f"{s_step:.5f} s/step, {batch / s_step:.4f} tiles/s; peak "
            f"max_memory_allocated {peak / 2 ** 30:.3f} GiB; launches "
            f"{launches[name]}; losses {[round(r['loss'], 5) for r in recs]}"
            f"; terms of the last step " + ", ".join(
                f"{k} {recs[-1][k]:.5f}" for k in terms if k != "loss"))
        db = runner._device_batch(next(iter(build_dataloader(
            cfg.dataset.train, cfg))))
        rows, total_ms, conv_ms = profile_step(runner, db)
        log(f"{name}: profiled step, device ms {total_ms:.3f} (kernels), "
            f"convolutions {conv_ms:.3f} ms ({conv_ms / total_ms:.1%}); top "
            f"ops by own device time: " + "; ".join(
                f"{k} {ms:.3f} ms ({ms / total_ms:.1%}, x{n})"
                for ms, k, n in rows))
        del runner, db
        torch.cuda.empty_cache()
    return launches


def phase_zoo_card_vs_cpu(root, log_root):
    """Phase 14: each of the four configs at tiny widths, the port on the
    card against the port on the CPU, float32, TF32 off, from the same
    seeded weights."""
    import numpy as np
    import torch
    from lanemapping_tpu_torch.config.config import Config
    from lanemapping_tpu_torch.data.loader import build_dataloader
    from lanemapping_tpu_torch.data.synthetic import generate_dataset
    from lanemapping_tpu_torch.decode.postprocess import lane_maps_from_decode
    from lanemapping_tpu_torch.decode.row_decode import row_lane_maps
    from lanemapping_tpu_torch.engine.runner import KLANE_HEADS, Runner
    from lanemapping_tpu_torch.engine.state import eval_step
    from lanemapping_tpu_torch.tools.export_lanes import lane_records

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    names = [f"{190000 + i:06d}_{i:04d}" for i in range(6)]
    generate_dataset(root, n_tiles=6, img=192, seed=5, splits={
        "train": names[:4], "valid": names[4:], "test": names[4:]})
    for name, (path, _) in ZOO.items():
        cfg = Config.fromfile(os.path.join(HERE, "configs", path))
        cfg.merge_from_dict({**ZOO_TINY_COMMON, **ZOO_TINY[name]})
        for split in ("train", "val", "test"):
            cfg.dataset[split]["data_root"] = root
        runners = {d: Runner(cfg, log_dir=os.path.join(log_root, name, d),
                             device=d) for d in ("cpu", "cuda")}
        batch = next(iter(build_dataloader(cfg.dataset.val, cfg,
                                           is_train=False)))
        outs, decided = {}, {}
        for d, r in runners.items():
            outs[d] = {k: v.float().cpu().numpy() for k, v in eval_step(
                r.model, r._eval_input(batch)).items()}
            if cfg.net.type == "Segmentor":
                decided[d] = r._host(r._eval_seg(batch))
                continue
            if r.head_type in KLANE_HEADS:
                maps = row_lane_maps(r._host(r._eval_grid(batch)), cfg,
                                     r.head_type)
                decided[d] = {"cls_idx": maps["cls_idx"]}
            else:
                maps = lane_maps_from_decode(r._host(r._eval_decode(batch)),
                                             cfg)
                decided[d] = {}
            decided[d]["records"] = [lane_records(m)
                                     for m in maps["cls_offset_smooth"]]
        worst = max((float(np.abs(outs["cuda"][k] - outs["cpu"][k]).max()
                           / max(1e-3, np.abs(outs["cpu"][k]).max())), k)
                    for k in outs["cpu"])
        check(set(outs["cuda"]) == set(outs["cpu"]) and worst[0] < 2e-3,
              f"tiny {name}: {worst[1]} rel-max {worst[0]:.3e} >= 2e-3")
        n_rec = 0
        for k, c in decided["cpu"].items():
            g = decided["cuda"][k]
            if k != "records":
                check(np.array_equal(g, c), f"tiny {name}: {k} differs")
                continue
            for rg, rc in zip(g, c):
                check([(r["lane_id"], r["seq_len"]) for r in rg]
                      == [(r["lane_id"], r["seq_len"]) for r in rc],
                      f"tiny {name}: lane records differ")
                for a, b in zip(rg, rc):
                    sa, sb = np.asarray(a["seq"]), np.asarray(b["seq"])
                    check(np.array_equal(sa[:, [0, 2]], sb[:, [0, 2]]) and
                          np.allclose(sa[:, 1], sb[:, 1], atol=1e-3),
                          f"tiny {name}: lane {a['lane_id']} differs")
                    n_rec += 1

        train_batch = next(iter(build_dataloader(cfg.dataset.train, cfg)))
        stats = {d: r.train_step(r.state, r._device_batch(train_batch))
                 for d, r in runners.items()}
        worst_loss = (0.0, "")
        for k in stats["cpu"]:
            c, g = float(stats["cpu"][k]), float(stats["cuda"][k])
            err = abs(g - c) / max(abs(c), 1e-12) if c or g else 0.0
            check(err < 1e-4, f"tiny {name} step {k}: card {g} cpu {c} "
                  f"(rel {err:.3e})")
            worst_loss = max(worst_loss, (err, k))
        log(f"tiny {name} card vs cpu: worst output rel-max {worst[0]:.3e} "
            f"({worst[1]}); decoded maps {sorted(decided['cpu'])} "
            f"identical ({n_rec} lane records, columns to 1e-3 px); one "
            f"step's loss {float(stats['cpu']['loss']):.6f}, worst term rel "
            f"{worst_loss[0]:.3e} ({worst_loss[1]})")


# phase 16/17: the two optional branches of ColumnProposal2
BRANCHES = ("column_att", "column_transformer_decoder")
# phase 17's tiny token widths (those of the JAX package's branch test) and
# weight seeds that put every decision of the decode on phase 17's inputs
# at least 1.1e-3 and 2.2e-3 from its threshold (measured on the CPU; the
# run asserts 1e-4)
BRANCH_TINY = {"heads.dim_token": 64, "heads.tr_heads": 4,
               "heads.tr_dim_head": 16, "heads.tr_mlp_dim": 128}
BRANCH_SEEDS = {"column_att": 39, "column_transformer_decoder": 30}


def lifted(pc_dir):
    """Every lifted vertex 3-D and finite; (files, lanes, vertices)."""
    import numpy as np
    files = sorted(f for f in os.listdir(pc_dir) if f.endswith(".json"))
    n_lanes = n_verts = 0
    for f in files:
        with open(os.path.join(pc_dir, f)) as fh:
            for r in json.load(fh):
                seq = np.asarray(r["seq"], np.float64)
                check(seq.ndim == 2 and seq.shape[1] == 3,
                      f"{f}: vertex shape {seq.shape}")
                check(np.isfinite(seq).all(), f"{f}: non-finite 3-D vertex")
                n_lanes += 1
                n_verts += len(seq)
    return files, n_lanes, n_verts


def same_files(a, b):
    """Whether two directories hold the same files, byte for byte."""
    import filecmp
    names = sorted(os.listdir(a))
    return names == sorted(os.listdir(b)) and all(
        filecmp.cmp(os.path.join(a, n), os.path.join(b, n), shallow=False)
        for n in names)


def check_lift(lanes_dir, data_root, params_dir, tmp, what):
    """The 3-D files beside ``lanes_dir``: vertices 3-D and finite, merged
    and down-sampled maps non-empty, all equal to a serial lift and merge
    of the same 2-D lanes.  Returns (tiles lifted, lanes, vertices)."""
    import shutil
    from lanemapping_tpu_torch.tools.img2pc import convert_directory
    from lanemapping_tpu_torch.tools.merge_lines import merge_directory
    parent = os.path.dirname(lanes_dir)
    pc_dir = os.path.join(parent, "out_pc_seq_json_dir")
    for f in ("merged.txt", "merged_downsample.txt"):
        path = os.path.join(pc_dir, f)
        check(os.path.isfile(path) and os.path.getsize(path) > 0,
              f"{what}: {f} missing or empty")
    files, n_lanes, n_verts = lifted(pc_dir)
    n_tiles = len([f for f in files if not f.startswith("merged")])
    check(n_tiles > 0, f"{what}: no tile lifted")
    serial = os.path.join(tmp, "serial_" + what.replace(" ", "_"))
    ref = convert_directory(shutil.copytree(lanes_dir, os.path.join(
        serial, "lanes_2d")), os.path.join(data_root, "cropped_tiff"),
        params_dir, n_workers=1)
    merge_directory(ref)
    check(same_files(ref, pc_dir) and same_files(
        os.path.join(serial, "out_pc_seq_txt_dir"),
        os.path.join(parent, "out_pc_seq_txt_dir")),
        f"{what}: the worker pool's 3-D files differ from a serial lift")
    return n_tiles, n_lanes, n_verts


def _in_bad_fork(_):
    import torch
    return torch.cuda._is_in_bad_fork()


def phase_map3d(root, stems, tmp):
    """Phase 15: the 3-D lane map on the card.  Returns {path: launch
    counts}."""
    import multiprocessing
    import numpy as np
    import torch
    from lanemapping_tpu_torch import LaneMapper
    from lanemapping_tpu_torch.data.synthetic import write_transform_params
    from lanemapping_tpu_torch.tools import stream_map

    # phase 7's clouds stay as they were: the params come from their own
    # RandomState, after the dataset
    params_dir = os.path.join(root, "cropped_tiff_param")
    os.makedirs(params_dir, exist_ok=True)
    for i, stem in enumerate(stems):
        write_transform_params(os.path.join(params_dir, stem + ".txt"), stem,
                               np.random.RandomState(1000 + i))
    torch_defaults()
    launches = {}
    out = os.path.join(tmp, "map3d_stream")
    reset_launches()
    t0 = time.perf_counter()
    rec = stream_map.main([LIDAR, root, "--split", "infer_only", "--batch",
                           str(B), "--out", out, "--seed", "0",
                           "--params-dir", params_dir, "--bench-json"])
    wall = time.perf_counter() - t0
    launches["stream_map_lidar"] = read_launches()
    check(launches["stream_map_lidar"]["voxel_bin_mean"] > 0,
          "the 3-D map's LiDAR stream never launched K1z")
    check(rec["merged_map"] == os.path.join(rec["pc_dir"], "merged.txt"),
          f"stream_map record {rec.get('merged_map')}")
    _, n_2d = check_lane_jsons(rec["lanes_dir"], len(stems))
    n_tiles, n_lanes, n_verts = check_lift(rec["lanes_dir"], root,
                                           params_dir, tmp, "stream_map")
    log(f"3-D map, LiDAR stream_map --params-dir: {rec['n_tiles']} tiles "
        f"({rec['value']:.4f} tiles/s streamed), {n_2d} 2-D lanes; lift and "
        f"merge {rec['lift_s']:.3f} s ({n_tiles} tiles lifted, {n_lanes} "
        f"lanes, {n_verts} 3-D vertices); run {wall:.3f} s; launches "
        f"{launches['stream_map_lidar']}; equal to a serial lift")

    # the lift's workers are forked from this process, whose CUDA context
    # is live: torch marks them, so a CUDA call there would raise
    with multiprocessing.Pool(2) as pool:
        marked = pool.map(_in_bad_fork, range(2))
    check(all(marked), f"forked workers not marked as such: {marked}")
    check(float(torch.ones(4, device="cuda").sum()) == 4.0,
          "CUDA unusable after the forked lift")

    out = os.path.join(tmp, "map3d_mapper")
    reset_launches()
    t0 = time.perf_counter()
    mapper = LaneMapper(FLAGSHIP, device="cuda",
                        log_dir=os.path.join(out, "log"))
    t1 = time.perf_counter()
    lanes_dir = mapper.map_directory(root, out, params_dir=params_dir)
    wall = time.perf_counter() - t1
    launches["map_directory"] = read_launches()
    check(mapper.device.type == "cuda", f"mapper on {mapper.device}")
    _, n_2d = check_lane_jsons(lanes_dir, len(stems))
    n_tiles, n_lanes, n_verts = check_lift(lanes_dir, root, params_dir, tmp,
                                           "map_directory")
    log(f"3-D map, LaneMapper(flagship, cuda).map_directory(params_dir): "
        f"{len(stems)} tiles, {n_2d} 2-D lanes, {n_tiles} tiles lifted, "
        f"{n_lanes} lanes, {n_verts} 3-D vertices in {wall:.3f} s (mapper "
        f"built in {t1 - t0:.3f} s); launches {launches['map_directory']};"
        f" equal to a serial lift")
    del mapper
    torch.cuda.empty_cache()
    return launches


def train_three_steps(name, cfg, log_dir):
    """``Runner.train(max_iters=3)`` with CUDA events per step: (s/step
    after the warm-up step, peak GiB, launch counts, train records)."""
    import torch
    from lanemapping_tpu_torch.engine.runner import Runner

    runner = Runner(cfg, log_dir=log_dir)
    check(runner.device.type == "cuda", f"{name}: on {runner.device}")
    step, times = runner.train_step, []

    def timed_step(state, b):
        a = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        a.record()
        stats = step(state, b)  # reads the loss on the host
        e.record()
        times.append((a, e))
        return stats

    runner.train_step = timed_step
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    runner.train(max_iters=3)
    torch.cuda.synchronize()
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    recs = train_records(log_dir)
    check(len(recs) == 3, f"{name}: {len(recs)} steps logged")
    for r in recs:
        bad = [k for k in TERMS + ("loss",) if not math.isfinite(r[k])]
        check(not bad, f"{name}: non-finite {bad} at step {r['iter']}")
        check(r["skipped_nan"] == 0.0, f"{name}: NaN guard fired")
    step_ms = [a.elapsed_time(e) for a, e in times]
    del runner
    torch.cuda.empty_cache()
    return sum(step_ms[1:]) / len(step_ms[1:]) / 1e3, peak, launches, recs


def phase_branches(las_root, lidar_root, tmp):
    """Phase 16: the flagship with each branch at full width, bf16, batch
    8: serving from phase 4's clouds, then 3 training steps.  Returns
    {branch: {"serving": launch counts, "training": launch counts}}."""
    from lanemapping_tpu_torch.config.config import Config
    from lanemapping_tpu_torch.tools import stream_map

    torch_defaults()
    launches = {}
    for branch in BRANCHES:
        out = os.path.join(tmp, "branch_" + branch)
        reset_launches()
        rec = stream_map.main([FLAGSHIP, las_root, f"{branch}=True",
                               "--from-las", "--batch", str(B), "--out", out,
                               "--seed", "0", "--bench-json"])
        serving = read_launches()
        check(serving["bev_bin_mean"] > 0,
              f"{branch}: the serving path never launched K1")
        check(rec["n_tiles"] == N_CLOUDS and rec["dtype"] == "bfloat16",
              f"{branch}: {rec['n_tiles']} tiles in {rec['dtype']}")
        names, n_lanes = check_lane_jsons(rec["lanes_dir"], N_CLOUDS)
        cfg = Config.fromfile(FLAGSHIP)
        cfg[branch] = True
        check_flagship_head_maps(cfg, las_root, names)
        ms = rec["stage_ms_per_batch"]
        log(f"{branch} serving: {rec['value']:.4f} tiles/s ({rec['n_tiles']}"
            f" tiles, batch {rec['batch']}, bf16, {rec['wall_s']:.4f} s); "
            f"ms per batch forward {ms['forward']:.4f}, decode "
            f"{ms['decode']:.4f}, rasterize {ms['rasterize']:.4f}, host "
            f"postprocess {ms['postprocess_host']:.4f}; lanes {n_lanes}; "
            f"launches {serving}; head maps finite with the expected "
            f"shapes")

        cfg = train_cfg(FLAGSHIP, lidar_root, log_every=1, eval_ep=10 ** 6,
                        save_ep=10 ** 6, gt_cache=True, workers=8)
        cfg[branch] = True
        s_step, peak, training, recs = train_three_steps(
            branch, cfg, os.path.join(tmp, "branch_train_" + branch))
        log(f"{branch} training: 3 steps of batch {cfg.batch_size} (bf16); "
            f"after the warm-up step {s_step:.5f} s/step, "
            f"{cfg.batch_size / s_step:.4f} tiles/s; peak "
            f"max_memory_allocated {peak:.3f} GiB; launches {training}; "
            f"losses {[round(r['loss'], 5) for r in recs]}")
        launches[branch] = {"serving": serving, "training": training}
    return launches


def fixed_input_net(head, ins, enc):
    """A ColumnProposal2 head on fixed seeded inputs, as a net for the
    port's train step: whatever tile it is given, it returns the head's
    maps (image maps NHWC, as Detector1stage returns them) and the fixed
    encoder maps the loss and the decode also read."""
    import torch

    class FixedInputNet(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.heads = head
            for i, a in enumerate(ins):
                self.register_buffer(f"in{i}", a)
            for k, v in enc.items():
                self.register_buffer(k, v)

        def forward(self, _tile):
            out = self.heads(self.in0, self.in1, self.in2)
            for k in ("orient", "endpoint"):
                if k in out:
                    out[k] = out[k].permute(0, 2, 3, 1)
            out["semantic_seg"] = self.semantic_seg
            out["endp_est"] = self.endp_est
            return out

    return FixedInputNet()


def decision_margin(dec, cfg, img):
    """The least distance of a decision of the decode from its threshold:
    proposal confidence, existence class, the column argmax at kept
    vertices, the kept columns from an integer (the tracker's cell)."""
    import numpy as np
    conf = dec["prop_conf"][..., 1]
    margins = [np.abs(conf - cfg.proposal_obj_thre).min()]
    kept = (conf >= cfg.proposal_obj_thre)[..., None] \
        & (dec["prop_v_ext"] > 0.5)
    probs = np.sort(dec["prop_cls_conf"], axis=-1)
    if kept.any():
        margins.append((probs[..., -1] - probs[..., -2])[kept].min())
        coors = dec["cls_offset"] / cfg.heads.row_size * img
        frac = np.abs(coors - np.round(coors))[kept & (coors > 0)]
        if frac.size:
            margins.append(frac.min())
    return float(min(margins))


def phase_branch_card_vs_cpu(root, log_root):
    """Phase 17: each branch's head at tiny widths, the port on the card
    against the port on the CPU, float32, TF32 off, from the same seeded
    weights and inputs: outputs, decoded lane records, 3 train steps."""
    import torch
    from lanemapping_tpu_torch.config.config import Config
    from lanemapping_tpu_torch.data.synthetic import generate_dataset

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    generate_dataset(root, n_tiles=4, img=192, seed=3)
    for branch in BRANCHES:
        cfg = Config.fromfile(TINY)
        cfg[branch] = True
        cfg.merge_from_dict(BRANCH_TINY)
        head_card_vs_cpu(f"tiny {branch}", cfg, BRANCH_SEEDS[branch], root,
                         os.path.join(log_root, branch))


def head_card_vs_cpu(what, cfg, seed, root, log_dir):
    """A column-contract head of ``cfg`` at tiny widths on fixed seeded
    inputs (the encoder's maps as fixed seeded logits), the port on the
    card against the port on the CPU, from the weights of ``seed``:
    outputs within rel-max 1e-5, identical lane records at a seed whose
    decisions clear their thresholds by 1e-4, and three train steps from a
    seeded mid-training Adam state with every loss term within rel 1e-6
    (phases 17 and 19)."""
    import numpy as np
    import torch
    from lanemapping_tpu_torch.api import to_numpy
    from lanemapping_tpu_torch.data.loader import build_dataloader
    from lanemapping_tpu_torch.decode.lane_decode import (decode_lanes,
                                                          host_decode_view)
    from lanemapping_tpu_torch.decode.postprocess import lane_maps_from_decode
    from lanemapping_tpu_torch.engine.runner import Runner
    from lanemapping_tpu_torch.engine.state import (create_train_state,
                                                    make_train_step)
    from lanemapping_tpu_torch.models.head_losses import (
        column_proposal_loss, head_hparams)
    from lanemapping_tpu_torch.models.nets import init_weights
    from lanemapping_tpu_torch.registry import build_heads
    from lanemapping_tpu_torch.tools.export_lanes import lane_records

    for split in ("train", "val", "test"):
        cfg.dataset[split]["data_root"] = root
    S, img = cfg.heads.row_size, cfg.list_img_size_xy[0]
    batch = next(iter(build_dataloader(cfg.dataset.train, cfg)))
    nb = len(batch["image_name"])
    rng = np.random.RandomState(6)
    ins = [torch.from_numpy(rng.randn(*s).astype(np.float32)) for s in (
        (nb, 2, S, S), (nb, 8, 2 * S, 2 * S), (nb, 1, 8 * S, 8 * S))]
    enc = {k: torch.from_numpy((2 * rng.randn(*s)).astype(np.float32))
           for k, s in (("semantic_seg", (nb, img, img, 3)),
                        ("endp_est", (nb, img, img, 1)))}
    head = init_weights(build_heads(cfg), torch.Generator().manual_seed(seed))
    nets = {"cpu": fixed_input_net(head, ins, enc)}
    nets["cuda"] = copy.deepcopy(nets["cpu"]).cuda()
    outs, recs, margin = {}, {}, None
    for d, net in nets.items():
        with torch.inference_mode():
            out = net.eval()(None)
            outs[d] = {k: v.float().cpu().numpy() for k, v in out.items()}
            dec = to_numpy(decode_lanes(out, cfg))
        if d == "cpu":
            margin = decision_margin(dec, cfg, img)
        maps = lane_maps_from_decode(host_decode_view(dec), cfg)
        recs[d] = [lane_records(m) for m in maps["cls_offset_smooth"]]
    check(margin > 1e-4, f"{what}: a decision {margin:.2e} from its "
          f"threshold; choose another weight seed")
    worst = max((float(np.abs(outs["cuda"][k] - outs["cpu"][k]).max()
                       / max(1e-3, np.abs(outs["cpu"][k]).max())), k)
                for k in outs["cpu"])
    check(worst[0] < 1e-5, f"{what}: {worst[1]} rel-max {worst[0]:.3e} >= "
          f"1e-5")
    n_rec = 0
    for g, c in zip(recs["cuda"], recs["cpu"]):
        check([(r["lane_id"], r["seq_len"]) for r in g]
              == [(r["lane_id"], r["seq_len"]) for r in c],
              f"{what}: lane records differ")
        for a, b in zip(g, c):
            sa, sb = np.asarray(a["seq"]), np.asarray(b["seq"])
            check(np.array_equal(sa[:, [0, 2]], sb[:, [0, 2]]) and
                  np.allclose(sa[:, 1], sb[:, 1], atol=1e-3),
                  f"{what}: lane {a['lane_id']} differs")
            n_rec += 1
    check(n_rec > 0, f"{what}: no lane record decoded")

    # three train steps from a seeded mid-training Adam state at a tenth
    # of the config's lr, as phase 11
    cfg.optimizer.lr = cfg.optimizer.lr / 10
    cfg.scheduler.T_max = 1000
    hp = head_hparams(cfg)
    step = make_train_step(lambda o, b: column_proposal_loss(o, b, hp))
    probe = copy.deepcopy(nets["cpu"]).train()
    db = Runner(cfg, log_dir=log_dir, device="cpu")._device_batch(batch)
    loss = column_proposal_loss(probe(None), db, hp)["loss"]
    grads = torch.autograd.grad(loss, list(probe.parameters()),
                                allow_unused=True)
    stats = {}
    for d, net in nets.items():
        state = create_train_state(net, cfg)
        seed_adam(state, grads, seed=1)
        dev_db = {k: v.to(d) for k, v in db.items()}
        stats[d] = [step(state, dev_db) for _ in range(3)]
    worst_loss = (0.0, "")
    for i, (sc, sg) in enumerate(zip(stats["cpu"], stats["cuda"])):
        for k in TERMS + ("loss",):
            c, g = float(sc[k]), float(sg[k])
            err = abs(g - c) / max(abs(c), 1e-12) if c or g else 0.0
            check(err < 1e-6, f"{what} step {i} {k}: card {g} cpu {c} (rel "
                  f"{err:.3e})")
            worst_loss = max(worst_loss, (err, f"step {i} {k}"))
    log(f"{what} card vs cpu: worst output rel-max {worst[0]:.3e} "
        f"({worst[1]}); {n_rec} lane records identical (columns to 1e-3 "
        f"px), decisions at least {margin:.2e} from their thresholds; 3 "
        f"train steps, losses cpu "
        f"{[round(float(s['loss']), 6) for s in stats['cpu']]}, worst term "
        f"rel {worst_loss[0]:.3e} ({worst_loss[1]})")


# phases 18/19: RowSharNotReducRef_Base, the FPN flags with the bf16-moment
# Adam, the ResnetFPN family and Swin
BASE_HEAD = {"heads.type": "RowSharNotReducRef_Base"}
# phase 19's tiny widths (those of the JAX package's test of the head) and
# a weight seed that puts every decision of the decode on phase 19's inputs
# at least 2.2e-2 from its threshold (measured on the CPU; the run asserts
# 1e-4)
BASE_TINY = {**BASE_HEAD, "heads.dim_token": 64, "heads.tr_heads": 4,
             "heads.tr_dim_head": 16, "heads.tr_mlp_dim": 128,
             "heads.row_dim_token": 32, "heads.row_tr_heads": 4,
             "heads.row_tr_dim_head": 8, "heads.row_tr_mlp_dim": 64}
BASE_SEED = 57
FPN_FLAGS = {"s2d_stem": True, "endp_head_extra": True, "remat": True,
             "optimizer.mu_dtype": "bfloat16"}
# Swin-T's published widths, and the JAX package's test Swin
SWIN_T = {"embed_dim": 96, "depths": (2, 2, 6, 2),
          "num_heads": (3, 6, 12, 24), "window_size": 7}
CORR_SIDE = IMG // 8  # the flagship correlator's map, 144 = 9 * 2^4
SWIN_IMG = 896  # 224 tokens a side: 32 windows of 7 in stage 0
SWIN_TINY = {"embed_dim": 32, "depths": (2, 2), "num_heads": (2, 4),
             "window_size": 4, "out_indices": (0, 1)}


def rel_max(got, want):
    """max |got - want| / max(1e-3, max |want|), on host copies."""
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    return float((got - want).abs().max() / max(1e-3,
                                                 float(want.abs().max())))


def fwd_bwd(model, x, iters=3):
    """Training-mode forward + backward of a backbone (the mean square of
    its outputs as the loss): ms per call from CUDA events after a warm-up
    call, and the peak ``max_memory_allocated`` GiB of the timed calls."""
    import torch

    def run():
        out = model(x)
        outs = out if isinstance(out, tuple) else (out,)
        sum(o.float().square().mean() for o in outs).backward()

    model.train()
    run()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        run()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters, torch.cuda.max_memory_allocated() / 2**30


def optimizer_step_ms(runner, iters=5):
    """ms of one step of the Runner's optimizer and of ``torch.optim.Adam``
    (foreach) over the same parameters with seeded gradients, from CUDA
    events after a warm-up step.  It moves the parameters: call it on a
    Runner that is thrown away."""
    import torch

    params = [p for p in runner.model.parameters() if p.requires_grad]
    dev = params[0].device
    g = torch.Generator(device=dev).manual_seed(0)
    for p in params:
        p.grad = torch.randn(p.shape, generator=g, device=dev) * 1e-3
    out = {"params": len(params), "numel": sum(p.numel() for p in params)}
    for name, opt in (("mu_dtype_adam", runner.state.optimizer),
                      ("torch_adam", torch.optim.Adam(params, lr=1e-4,
                                                      foreach=True))):
        opt.step()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            opt.step()
        b.record()
        b.synchronize()
        out[name] = a.elapsed_time(b) / iters
    return out


def phase_zoo_models(las_root, lidar_root, tmp):
    """Phase 18: the slice's models at full width on the card.  Returns
    {path: launch counts}."""
    import torch
    import torch.nn.functional as F
    from lanemapping_tpu_torch.config.config import Config
    from lanemapping_tpu_torch.engine.optimizer import MuDtypeAdam
    from lanemapping_tpu_torch.engine.runner import Runner
    from lanemapping_tpu_torch.models.resnet_fpn import (
        FPNEncoder, _space_to_depth, load_s2d_stem)
    from lanemapping_tpu_torch.models.resnet_fpn_family import FAMILY
    from lanemapping_tpu_torch.registry import BACKBONE
    from lanemapping_tpu_torch.tools import stream_map

    torch_defaults()
    launches = {}
    # the flagship with RowSharNotReducRef_Base: serving from phase 4's
    # clouds, then 3 training steps on phase 7's dataset
    out = os.path.join(tmp, "base_serving")
    reset_launches()
    rec = stream_map.main([FLAGSHIP, las_root,
                           "heads.type=RowSharNotReducRef_Base",
                           "--from-las", "--batch", str(B), "--out", out,
                           "--seed", "0", "--bench-json"])
    serving = read_launches()
    # once per batch, and once for the warm-up on the first batch
    check(serving["bev_bin_mean"] == math.ceil(N_CLOUDS / B) + 1,
          f"the Base head's serving path launched K1 "
          f"{serving['bev_bin_mean']} times for {N_CLOUDS} clouds at batch "
          f"{B}")
    check(rec["n_tiles"] == N_CLOUDS and rec["dtype"] == "bfloat16",
          f"base head: {rec['n_tiles']} tiles in {rec['dtype']}")
    names, n_lanes = check_lane_jsons(rec["lanes_dir"], N_CLOUDS)
    cfg = Config.fromfile(FLAGSHIP)
    cfg.merge_from_dict(BASE_HEAD)
    S = cfg.heads.row_size
    check_flagship_head_maps(cfg, las_root, names,
                             extra={"endpoint": (B, 8 * S, 8 * S, 1)})
    ms = rec["stage_ms_per_batch"]
    log(f"base head serving: {rec['value']:.4f} tiles/s ({rec['n_tiles']} "
        f"tiles, batch {rec['batch']}, bf16, {rec['wall_s']:.4f} s); ms per "
        f"batch forward {ms['forward']:.4f}, decode {ms['decode']:.4f}, "
        f"rasterize {ms['rasterize']:.4f}, host postprocess "
        f"{ms['postprocess_host']:.4f}; lanes {n_lanes}; launches {serving};"
        f" head maps finite with the expected shapes")

    def train_cfg3(over):
        cfg = train_cfg(FLAGSHIP, lidar_root, log_every=1, eval_ep=10 ** 6,
                        save_ep=10 ** 6, gt_cache=True, workers=8)
        cfg.merge_from_dict(over)
        return cfg

    s_step, peak, training, recs = train_three_steps(
        "base head", train_cfg3(BASE_HEAD), os.path.join(tmp, "base_train"))
    log(f"base head training: 3 steps of batch {B} (bf16); after the "
        f"warm-up step {s_step:.5f} s/step, {B / s_step:.4f} tiles/s; peak "
        f"max_memory_allocated {peak:.3f} GiB; launches {training}; losses "
        f"{[round(r['loss'], 5) for r in recs]}")
    launches["base_head"] = {"serving": serving, "training": training}

    # the FPN flags with the bf16-moment Adam, then remat's "dots" policy
    for name, over in (("flags", FPN_FLAGS),
                       ("remat dots", {"remat": True,
                                       "remat_policy": "dots"})):
        cfg = train_cfg3(over)
        probe = Runner(cfg, log_dir=os.path.join(tmp, "probe"))
        fpn = probe.model.pcencoder.fpn
        check(type(fpn.layer1).__name__ == "RematStage"
              and fpn.layer1.policy == cfg.get("remat_policy", "full"),
              f"{name}: the trunk is not checkpointed")
        if name == "flags":
            check(hasattr(fpn, "conv1_s2d") and hasattr(fpn, "endp_extra")
                  and isinstance(probe.state.optimizer, MuDtypeAdam),
                  "flags: s2d stem, endpoint extra or bf16-moment Adam "
                  "missing")
            adam_ms = optimizer_step_ms(probe)
            log(f"flags: one optimizer step over the flagship's "
                f"{adam_ms['params']} parameter tensors "
                f"({adam_ms['numel']} values), ms (CUDA events, mean of 5 "
                f"after a warm-up): bf16-moment MuDtypeAdam "
                f"{adam_ms['mu_dtype_adam']:.4f}, torch.optim.Adam "
                f"(foreach) {adam_ms['torch_adam']:.4f}")
        del probe, fpn
        s_step, peak, training, recs = train_three_steps(
            name, cfg, os.path.join(tmp, "train_" + name.replace(" ", "_")))
        log(f"{name} training ({over}): 3 steps of batch {B} (bf16); after "
            f"the warm-up step {s_step:.5f} s/step, {B / s_step:.4f} "
            f"tiles/s; peak max_memory_allocated {peak:.3f} GiB; launches "
            f"{training}; losses {[round(r['loss'], 5) for r in recs]}")
        launches[name] = {"training": training}

    # an s2d stem with a loaded 7x7 kernel against the 7x7 conv, float32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator().manual_seed(0)
    plain = FPNEncoder().cuda()
    with torch.no_grad():
        plain.conv1.weight.copy_(torch.randn(64, 3, 7, 7, generator=g)
                                 / 147 ** 0.5)
    s2d = FPNEncoder(s2d_stem=True).cuda()
    s2d.load_state_dict(load_s2d_stem(plain.state_dict(), s2d.state_dict()))
    x = torch.rand(B, 3, IMG, IMG, generator=g).cuda()
    with torch.no_grad():
        want = plain.conv1(x)
        got = s2d.conv1_s2d(F.pad(_space_to_depth(x), (2, 1, 2, 1)))
    check(got.shape == want.shape == (B, 64, IMG // 2, IMG // 2),
          f"s2d stem shape {tuple(got.shape)}")
    err = rel_max(got, want)
    check(err < 1e-5, f"s2d stem against the 7x7 conv: rel-max {err:.3e}")
    log(f"s2d stem with a loaded 7x7 kernel against the 7x7 conv at "
        f"[{B},3,{IMG},{IMG}] float32, TF32 off: rel-max {err:.3e}")
    del plain, s2d, x, got, want
    torch_defaults()

    # the family at the flagship's correlator input, Swin-T at its widths
    x = torch.randn(B, 64, CORR_SIDE, CORR_SIDE, generator=g).cuda() \
        .to(torch.bfloat16)
    for name in FAMILY:
        model = BACKBONE.get(name)(num_channels=64).cuda().to(torch.bfloat16)
        ms_, peak = fwd_bwd(model, x)
        out = model(x)
        check(out.shape[-2:] == x.shape[-2:] and bool(
            torch.isfinite(out).all()), f"{name}: {tuple(out.shape)}")
        log(f"{name} (num_channels 64) forward + backward at "
            f"{list(x.shape)} bf16: {ms_:.4f} ms, peak {peak:.3f} GiB, "
            f"output {list(out.shape)}")
        del model, out
        torch.cuda.empty_cache()
    x = torch.rand(B, 3, SWIN_IMG, SWIN_IMG, generator=g).cuda() \
        .to(torch.bfloat16)
    model = BACKBONE.get("SwinTransformer")(**SWIN_T).cuda() \
        .to(torch.bfloat16)
    ms_, peak = fwd_bwd(model, x)
    outs = model(x)
    side = SWIN_IMG // 4
    check([tuple(o.shape) for o in outs] == [
        (B, SWIN_T["embed_dim"] * 2 ** i, side >> i, side >> i)
        for i in range(4)]
        and all(bool(torch.isfinite(o).all()) for o in outs),
        f"Swin-T stages {[tuple(o.shape) for o in outs]}")
    log(f"Swin-T (embed 96, depths 2-2-6-2, heads 3-6-12-24, window 7) "
        f"forward + backward at [{B},3,{SWIN_IMG},{SWIN_IMG}] bf16: "
        f"{ms_:.4f} ms, peak "
        f"{peak:.3f} GiB, stages {[list(o.shape) for o in outs]}")
    del model, outs, x
    torch.cuda.empty_cache()
    return launches


def phase_zoo_models_card_vs_cpu(root, log_root):
    """Phase 19: phase 18's models at tiny widths, the port on the card
    against the port on the CPU, float32, TF32 off, from the same seeded
    weights and inputs."""
    import numpy as np
    import torch
    from lanemapping_tpu_torch.config.config import Config
    from lanemapping_tpu_torch.data.loader import build_dataloader
    from lanemapping_tpu_torch.data.synthetic import generate_dataset
    from lanemapping_tpu_torch.engine.runner import Runner
    from lanemapping_tpu_torch.engine.state import model_input
    from lanemapping_tpu_torch.models.nets import init_weights
    from lanemapping_tpu_torch.models.resnet_fpn_family import FAMILY
    from lanemapping_tpu_torch.registry import BACKBONE

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    generate_dataset(root, n_tiles=4, img=192, seed=3)
    cfg = Config.fromfile(TINY)
    cfg.merge_from_dict(BASE_TINY)
    head_card_vs_cpu("tiny base head", cfg, BASE_SEED, root,
                     os.path.join(log_root, "base"))

    # the flag run: 3 steps of the tiny config with every flag, as phase 11
    cfg = train_cfg(TINY, root)
    cfg.merge_from_dict(FPN_FLAGS)
    cfg.optimizer.lr = cfg.optimizer.lr / 10
    cfg.scheduler.T_max = 1000
    batch = next(iter(build_dataloader(cfg.dataset.train, cfg)))
    runners = {d: Runner(cfg, log_dir=os.path.join(log_root, "flags", d),
                         device=d) for d in ("cpu", "cuda")}
    probe = copy.deepcopy(runners["cpu"].model).train()
    db = runners["cpu"]._device_batch(batch)
    loss = runners["cpu"]._loss_fn(probe(model_input(db)), db)["loss"]
    grads = torch.autograd.grad(loss, list(probe.parameters()),
                                allow_unused=True)
    stats = {}
    for d, r in runners.items():
        seed_adam(r.state, grads, seed=1)
        for st in r.state.optimizer.state.values():  # stored as optax does
            st["exp_avg"] = st["exp_avg"].to(r.state.optimizer.mu_dtype)
        stats[d] = [r.train_step(r.state, r._device_batch(batch))
                    for _ in range(3)]
    worst_loss = 0.0
    for i, (sc, sg) in enumerate(zip(stats["cpu"], stats["cuda"])):
        for k in TERMS + ("loss",):
            c, g = float(sc[k]), float(sg[k])
            err = abs(g - c) / max(abs(c), 1e-12) if c or g else 0.0
            check(err < 1e-4, f"tiny flags step {i} {k}: card {g} cpu {c} "
                  f"(rel {err:.3e})")
            worst_loss = max(worst_loss, err)
    sd_c = runners["cpu"].model.state_dict()
    sd_g = runners["cuda"].model.state_dict()
    worst = max((rel_max(sd_g[k], c), k) for k, c in sd_c.items()
                if not k.endswith("num_batches_tracked"))
    check(worst[0] < 2e-3, f"tiny flags: {worst[1]} rel-max {worst[0]:.3e} "
          f">= 2e-3 after 3 steps")
    log(f"tiny flags ({FPN_FLAGS}) training card vs cpu: losses per step "
        f"cpu {[round(float(s['loss']), 6) for s in stats['cpu']]}, worst "
        f"term rel {worst_loss:.3e}; parameters and BatchNorm buffers worst "
        f"rel-max {worst[0]:.3e} ({worst[1]})")
    del runners, probe

    # the nine family backbones and the test Swin, eval and train mode
    x = torch.from_numpy(np.random.RandomState(0).randn(2, 8, 48, 48)
                         .astype(np.float32))
    models = [(n, BACKBONE.get(n)(num_channels=8,
                                  cfg={"featuremap_out_channel": 8}), x)
              for n in FAMILY]
    models.append(("Swin", BACKBONE.get("SwinTransformer")(**SWIN_TINY),
                   torch.from_numpy(np.random.RandomState(1).rand(
                       2, 3, 64, 64).astype(np.float32))))
    for i, (name, m, inp) in enumerate(models):
        m = init_weights(m, torch.Generator().manual_seed(i))
        worst = 0.0
        for train in (False, True):
            cpu, card = m.train(train), copy.deepcopy(m).cuda()
            with torch.no_grad():
                want, got = cpu(inp), card(inp.cuda())
            want = want if isinstance(want, tuple) else (want,)
            got = got if isinstance(got, tuple) else (got,)
            check(len(got) == len(want), f"{name}: outputs")
            for g, w in zip(got, want):
                worst = max(worst, rel_max(g, w))
        check(worst < 1e-5, f"tiny {name} card vs cpu: rel-max {worst:.3e}")
        log(f"tiny {name} card vs cpu, eval and train mode: rel-max "
            f"{worst:.3e}")


# -- phases 20 and 21: data parallelism on the one card ----------------------

DIST_STEPS = {"nccl": 2, "fp32": 3, "bf16": 4, "lidar": 2}


def dist_cfg(config, root, **over):
    """A training config for the data-parallel phases: every split at
    ``root``, every step logged, no validate or save inside the run."""
    return train_cfg(config, root, log_every=1, eval_ep=10 ** 6,
                     save_ep=10 ** 6, workers=8, **over)


def fp32_cfg(root):
    """The flagship in float32 at a tenth of its lr (phase 11's reason:
    larger steps part any two float32 runs of the ill-conditioned encoder
    at random weights)."""
    cfg = dist_cfg(FLAGSHIP, root, train_compute_dtype="float32")
    cfg.optimizer.lr = cfg.optimizer.lr / 10
    return cfg


def pin_fp32():
    import torch
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def run_train(cfg, log_dir, n_steps, device="cuda"):
    """``Runner.train(max_iters=n_steps)``: the Runner, every step's
    statistics (floats) and every step's (CUDA events ms, host s)."""
    import torch
    from lanemapping_tpu_torch.engine.runner import Runner
    runner = Runner(cfg, log_dir=log_dir, device=device)
    runner._tb = None  # the phase reads the step records
    step, recs, times = runner.train_step, [], []

    def timed(state, batch):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        stats = step(state, batch)
        b.record()
        b.synchronize()
        times.append((a.elapsed_time(b), time.perf_counter() - t0))
        recs.append({k: float(v) for k, v in stats.items()})
        return stats
    runner.train_step = timed
    runner.train(max_iters=n_steps)
    runner.train_step = step
    check(len(recs) == n_steps, f"{len(recs)} of {n_steps} steps ran")
    for r in recs:
        bad = [k for k, v in r.items() if not math.isfinite(v)]
        check(not bad and r["skipped_nan"] == 0.0,
              f"non-finite {bad} or a NaN-guard skip: {r}")
    return runner, recs, times


def collective_device_ms(prof):
    """From a ``torch.profiler`` trace of one step: (device ms of the
    collectives' work on the card, device ms of every kernel and copy).
    The collectives' work is NCCL's kernels and, for gloo, the copies
    between the card and the host (the step's other copies are a few
    scalar reads)."""
    from torch.autograd import DeviceType
    coll = total = 0.0
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        total += us / 1e3
        if "nccl" in ev.key.lower() or "memcpy" in ev.key.lower():
            coll += us / 1e3
    return coll, total


def collectives_alone(runner, db):
    """One train step in which every ``all_reduce`` runs alone: the card
    drained (``torch.cuda.synchronize``) and the ranks met (a barrier)
    before it, the card drained after it.  [(elements, host ms)] of each
    call, in order: the exchange itself, without the wait for this rank's
    queued kernels or for the other rank."""
    import torch
    import torch.distributed as tdist
    real, calls = tdist.all_reduce, []

    def alone(t, *a, **k):
        torch.cuda.synchronize()
        tdist.barrier()
        t0 = time.perf_counter()
        out = real(t, *a, **k)
        torch.cuda.synchronize()
        calls.append((t.numel(), (time.perf_counter() - t0) * 1e3))
        return out
    tdist.all_reduce = alone
    try:
        runner.train_step(runner.state, db)
        torch.cuda.synchronize()
    finally:
        tdist.all_reduce = real
    return calls


def dist_rank(rank, world, port, root, log_root, out_dir):
    """One rank of phase 20 (b)-(d) (a ``torch.multiprocessing.spawn``
    target): ranks sharing cuda:0 over gloo.  Writes
    ``<out_dir>/rank<rank>.json``."""
    sys.path.insert(0, HERE)
    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile
    from lanemapping_tpu_torch.data.loader import build_dataloader
    from lanemapping_tpu_torch.parallel.dist import (
        all_gather_host, maybe_initialize_distributed, shutdown)
    from lanemapping_tpu_torch.tools.multihost_test import state_digest

    dev = maybe_initialize_distributed(
        coordinator=f"127.0.0.1:{port}", num_processes=world,
        process_id=rank, devices=["cuda:0"] * world)
    res = {}
    try:
        check(torch.distributed.get_backend() == "gloo", "backend")
        # (b) float32, TF32 off, 3 steps and a validate
        pin_fp32()
        runner, recs, _ = run_train(fp32_cfg(root), os.path.join(
            log_root, "fp32"), DIST_STEPS["fp32"], dev)
        t0 = time.perf_counter()
        val = runner.validate()
        res["fp32"] = {"records": recs, "val": val,
                       "validate_s": time.perf_counter() - t0,
                       "digests": all_gather_host(state_digest(
                           runner.model))}
        del runner
        torch.cuda.empty_cache()

        # (c) the config's bf16, timed, then one step under the profiler
        torch_defaults()
        torch.cuda.reset_peak_memory_stats()
        cfg = dist_cfg(FLAGSHIP, root)
        runner, recs, times = run_train(cfg, os.path.join(log_root, "bf16"),
                                        DIST_STEPS["bf16"], dev)
        peak = torch.cuda.max_memory_allocated()
        db = runner._device_batch(next(iter(build_dataloader(
            cfg.dataset.train, cfg))))
        torch.cuda.synchronize()
        with torch_profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            runner.train_step(runner.state, db)
            torch.cuda.synchronize()
            step_s = time.perf_counter() - t0
        coll_dev, all_dev = collective_device_ms(prof)
        res["bf16"] = {"records": recs, "times": times, "peak_bytes": peak,
                       "profiled_step_s": step_s,
                       "collective_device_ms": coll_dev,
                       "device_ms": all_dev,
                       "alone": collectives_alone(runner, db),
                       "digests": all_gather_host(state_digest(
                           runner.model))}
        del runner, db
        torch.cuda.empty_cache()

        # (d) the LiDAR config: K1z once per step on each rank
        reset_launches()
        runner, recs, times = run_train(
            dist_cfg(LIDAR, root), os.path.join(log_root, "lidar"),
            DIST_STEPS["lidar"], dev)
        res["lidar"] = {"records": recs, "times": times,
                        "launches": read_launches()}
        del runner
    finally:
        shutdown()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)


def flat_state(model):
    return {k: v.detach().cpu().clone() for k, v in
            model.state_dict().items()}


def phase_dist_world_one(root, log_root):
    """Phase 20 (a): the flagship at full width, bf16, batch 8, 2 steps
    in a 1-rank NCCL group against the same 2 steps with no group, run
    twice.  The step is not reproducible bit for bit on the card (the
    bilinear upsample's backward accumulates with atomics: two no-group
    runs differ), so it holds what is: no collective is called at a world
    of one, the first step's loss terms are bit-identical, and after 2
    steps the parameter digest is within the multihost bar of the first
    no-group run's, as the second no-group run's is."""
    import torch
    import torch.distributed as tdist
    from lanemapping_tpu_torch.parallel.dist import (
        maybe_initialize_distributed, shutdown)
    from lanemapping_tpu_torch.tools.multihost_test import (BARS,
                                                            state_digest)
    from lanemapping_tpu_torch.parallel.dist import free_port

    torch_defaults()
    torch.backends.cudnn.deterministic = True
    calls = []
    names = ("all_reduce", "all_gather_object", "barrier", "broadcast")
    real = {n: getattr(tdist, n) for n in names}
    runs = {}
    try:
        for how in ("no group", "no group again", "nccl world 1"):
            if how == "nccl world 1":
                maybe_initialize_distributed(
                    coordinator=f"127.0.0.1:{free_port()}", num_processes=1,
                    process_id=0, devices=["cuda:0"])
                check(tdist.get_backend() == "nccl" and
                      tdist.get_world_size() == 1, "not a 1-rank NCCL group")
                for n in names:
                    setattr(tdist, n, lambda *a, n=n, **k: calls.append(n)
                            or real[n](*a, **k))
            runner, recs, _ = run_train(
                dist_cfg(FLAGSHIP, root),
                os.path.join(log_root, how.replace(" ", "_")),
                DIST_STEPS["nccl"])
            runs[how] = (recs, state_digest(runner.model)["param_digest"])
            del runner
            torch.cuda.empty_cache()
    finally:
        for n in names:
            setattr(tdist, n, real[n])
        shutdown()
        torch_defaults()
    check(not calls, f"collectives at a world of one: {calls}")
    base, digest = runs["no group"]
    rel = {}
    for how in ("no group again", "nccl world 1"):
        recs, d = runs[how]
        check(recs[0] == base[0], f"{how}: first step {recs[0]} != {base[0]}")
        rel[how] = abs(d - digest) / digest
        check(rel[how] < BARS["digest_rel"], f"{how}: digest rel {rel[how]}")
    log(f"20(a) flagship bf16 batch 8, {DIST_STEPS['nccl']} steps: in a "
        f"1-rank NCCL group no collective was called; first step loss "
        f"terms bit-identical to two runs with no group; parameter digest "
        f"rel to the first no-group run: NCCL world 1 "
        f"{rel['nccl world 1']:.3e}, "
        f"second no-group run {rel['no group again']:.3e} (bar "
        f"{BARS['digest_rel']}); losses "
        f"{[r['loss'] for r in runs['nccl world 1'][0]]} vs "
        f"{[r['loss'] for r in base]}")


def phase_dist_two_ranks(root, log_root):
    """Phase 20 (b)-(d): two ranks sharing the card over gloo, against one
    process.  Returns K1z's launches per rank in (d)."""
    import torch
    import torch.multiprocessing as mp
    from lanemapping_tpu_torch.tools.multihost_test import (BARS, compare,
                                                            state_digest)
    from lanemapping_tpu_torch.parallel.dist import free_port

    # the one-process reference of (b)
    pin_fp32()
    runner, recs, _ = run_train(fp32_cfg(root), os.path.join(
        log_root, "fp32_one"), DIST_STEPS["fp32"])
    t0 = time.perf_counter()
    one = {"losses": [r["loss"] for r in recs], "val": runner.validate(),
           "param_digest": state_digest(runner.model)["param_digest"]}
    one_val_s = time.perf_counter() - t0
    del runner
    torch.cuda.empty_cache()
    torch_defaults()

    out_dir = os.path.join(log_root, "ranks")
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.perf_counter()
    mp.spawn(dist_rank, args=(2, free_port(), root, log_root, out_dir),
             nprocs=2, join=True)
    log(f"20(b-d) two ranks spawned and joined in "
        f"{time.perf_counter() - t0:.3f} s")
    ranks = []
    for r in range(2):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))

    fp = [r["fp32"] for r in ranks]
    check(fp[0]["records"] == fp[1]["records"],
          "the ranks logged different global losses")
    two = {"losses": [r["loss"] for r in fp[0]["records"]],
           "val": fp[0]["val"],
           "param_digest": fp[0]["digests"][0]["param_digest"],
           "rank_sha256": [d["sha256"] for d in fp[0]["digests"]]}
    cmp = compare(one, two)
    check(cmp["pass"], f"20(b) two ranks against one process: {cmp}")
    log(f"20(b) flagship float32 (TF32 off), global batch 8 as 4+4, "
        f"{DIST_STEPS['fp32']} steps at lr/10: losses one process "
        f"{one['losses']}, two ranks {two['losses']} (max rel "
        f"{cmp['max_rel_loss_diff']:.3e} < {BARS['loss_rel']}); digest rel "
        f"{cmp['param_digest_rel_diff']:.3e} < {BARS['digest_rel']}; ranks "
        f"bit-identical; validate metrics abs diff "
        f"{cmp['val_metric_abs_diff']} < {BARS['metric_abs']} (one process "
        f"{one_val_s:.3f} s, two ranks {fp[0]['validate_s']:.3f} s)")

    bf = [r["bf16"] for r in ranks]
    check(len({d["sha256"] for d in bf[0]["digests"]}) == 1,
          "20(c) ranks differ after the bf16 steps")
    for r, b in enumerate(bf):
        ms = [t[0] for t in b["times"]][1:]
        s_step = sum(ms) / len(ms) / 1e3
        alone = b["alone"]
        check(alone, f"20(c) rank {r}: no all-reduce in the step")
        n_grad, grad_ms = max(alone)  # the flat gradient: the most elements
        alone_ms = sum(t for _, t in alone)
        log(f"20(c) rank {r}: flagship bf16 batch 4 of 8 on a shared card "
            f"(gloo): per step ms (CUDA events) "
            f"{[round(t[0], 4) for t in b['times']]}, host s "
            f"{[round(t[1], 4) for t in b['times']]}; after the warm-up "
            f"step {s_step:.5f} s/step; peak max_memory_allocated "
            f"{b['peak_bytes'] / 2 ** 30:.3f} GiB; each all-reduce alone "
            f"(card drained, ranks met): the flat gradient of {n_grad} "
            f"float32 {grad_ms:.3f} ms, all {len(alone)} calls "
            f"{alone_ms:.3f} ms ({alone_ms / (s_step * 1e3):.1%} of the "
            f"s/step); profiled step {b['profiled_step_s']:.5f} s, device "
            f"ms of collective copies and NCCL kernels "
            f"{b['collective_device_ms']:.3f} of {b['device_ms']:.3f} "
            f"device ms ({b['collective_device_ms'] / b['device_ms']:.1%})")

    launches = [r["lidar"]["launches"]["voxel_bin_mean"] for r in ranks]
    check(launches == [DIST_STEPS["lidar"]] * 2,
          f"20(d) K1z launches per rank {launches}, want one per step")
    log(f"20(d) LiDAR config on 2 ranks, batch 4 of 8 each, "
        f"{DIST_STEPS['lidar']} steps: K1z launched {launches} times per "
        f"rank; losses {[r['loss'] for r in ranks[0]['lidar']['records']]}; "
        f"step ms {[round(t[0], 4) for t in ranks[0]['lidar']['times']]}")
    return launches


# the decode's arrays that vary continuously with the head maps; the rest
# are argmax, threshold and endpoint top-K decisions, compared exactly, but
# ``cls_offset`` (the column ``cls`` plus the offset map's value there),
# which is continuous wherever ``cls`` agrees
CONTINUOUS_DECODE = ("prop_conf", "bi_seg_rows", "cls_exp", "endp_logits")
# phase 21's bounds on what two replicas may change against one: the share
# of decisions that differ (runs on the H100 saw a few of 16 tiles') and the
# share of tiles whose lanes differ; a wrong row split or tile order changes
# most of both at random weights
MAX_FLIP_SHARE = 1e-3
MAX_LANE_TILE_SHARE = 0.5


def same_lanes(a_path, b_path, px=0.05):
    """Two lane JSONs hold the same lanes: as many records, each with as
    many vertices, every vertex within ``px`` pixels."""
    import numpy as np
    with open(a_path) as f:
        a = json.load(f)
    with open(b_path) as f:
        b = json.load(f)
    if len(a) != len(b):
        return False
    for ra, rb in zip(a, b):
        sa = np.asarray(ra["seq"], np.float64)
        sb = np.asarray(rb["seq"], np.float64)
        if sa.shape != sb.shape or (np.abs(sa - sb) > px).any():
            return False
    return True


def phase_stream_replicas(root, out_root):
    """Phase 21: ``stream_map --from-las`` over ``devices=[cuda:0,
    cuda:0]``, batch 8 split 4+4, against one replica at batch 4 (the
    same forwards' shapes, so cuDNN and cuBLAS pick the same kernels),
    float32, TF32 off.  Returns K1's launches."""
    import numpy as np
    import torch
    import lanemapping_tpu_torch.decode.lane_decode as lane_decode
    from lanemapping_tpu_torch.tools import stream_map

    pin_fp32()
    real = (lane_decode.decode_lanes, lane_decode.host_decode_view)

    def host(d):
        return {k: v.float().cpu().numpy() for k, v in d.items()}

    runs, launches, recs = {}, {}, {}
    try:
        for n in (1, 2):
            maps, decs = [], []
            runs[n] = (maps, decs)
            lane_decode.decode_lanes = lambda out, cfg, maps=maps: \
                maps.append(host(out)) or real[0](out, cfg)
            lane_decode.host_decode_view = lambda dec, decs=decs: \
                decs.append(host(real[1](dec))) or real[1](dec)
            reset_launches()
            recs[n] = stream_map.main(
                [FLAGSHIP, root, "compute_dtype=float32", "--from-las",
                 "--batch", str(B * n // 2), "--out",
                 os.path.join(out_root, f"replicas{n}"), "--seed", "0"],
                devices=["cuda:0"] * n)
            launches[n] = read_launches()["bev_bin_mean"]
    finally:
        lane_decode.decode_lanes, lane_decode.host_decode_view = real
        torch_defaults()
    n_calls = recs[2]["n_batches"] + 1  # the warm-up batch runs twice
    check(launches[2] == 2 * n_calls,
          f"K1 launches {launches[2]}, want one per replica per batch "
          f"({n_calls} batches with the warm-up)")
    check(recs[2]["devices"] == ["cuda:0", "cuda:0"], recs[2]["devices"])
    # the timed forwards: one replica's 4-tile batches in tile order, and
    # the two replicas' halves of each 8-tile batch, replica 0 first
    worst, flips, n_decisions = (0.0, ""), {}, 0
    for what, i in (("map", 0), ("decode", 1)):
        one, two = runs[1][i][1:], runs[2][i][2:]
        check(len(one) == len(two) == N_CLOUDS // (B // 2),
              f"21: {len(one)} and {len(two)} forwards")
        for w, g in zip(one, two):
            for k, a in w.items():
                if what == "decode" and k == "cls_offset":
                    same = g["cls"] == w["cls"]
                    a, g_k = a[same], g[k][same]
                    if not a.size:
                        continue
                elif what == "decode" and k not in CONTINUOUS_DECODE:
                    flips[k] = flips.get(k, 0) + int((g[k] != a).sum())
                    n_decisions += a.size
                    continue
                else:
                    g_k = g[k]
                err = float(np.abs(g_k - a).max()
                            / max(1e-3, np.abs(a).max()))
                worst = max(worst, (err, f"{what} {k}"))
    check(worst[0] < 1e-5, f"21: {worst[1]} rel-max {worst[0]:.3e}")
    share = sum(flips.values()) / n_decisions
    check(share <= MAX_FLIP_SHARE,
          f"21: {flips} of {n_decisions} decisions differ ({share:.3e} > "
          f"{MAX_FLIP_SHARE})")
    names, n_lanes = check_lane_jsons(recs[2]["lanes_dir"], N_CLOUDS)
    check(names == sorted(os.listdir(recs[1]["lanes_dir"])),
          "21: the replicas wrote other tiles' lane JSONs")
    differ = [n for n in names if not same_lanes(
        os.path.join(recs[1]["lanes_dir"], n),
        os.path.join(recs[2]["lanes_dir"], n))]
    check(len(differ) <= MAX_LANE_TILE_SHARE * len(names),
          f"21: the lanes of {len(differ)} of {len(names)} tiles differ")
    log(f"21 stream_map --from-las over [cuda:0, cuda:0], float32, batch "
        f"{B} as {B // 2}+{B // 2}, against one replica at batch {B // 2}: "
        f"{recs[2]['n_tiles']} tiles, one lane JSON each ({n_lanes} "
        f"lanes); every head map and continuous decode array (cls_offset "
        f"where cls agrees) within rel-max {worst[0]:.3e} ({worst[1]}); "
        f"decision elements that differ {flips}, {sum(flips.values())} of "
        f"{n_decisions} ({share:.3e}, bound {MAX_FLIP_SHARE}); tiles whose "
        f"lanes differ (count, vertex count or a vertex by > 0.05 px) "
        f"{len(differ)} of {len(names)} {differ} (bound "
        f"{MAX_LANE_TILE_SHARE:.0%}); K1 launches {launches[2]} (one per "
        f"replica per batch, {n_calls} batches with the warm-up)")
    return launches[2]


def main():
    if not (os.path.isdir(os.path.join(HERE, "lanemapping_tpu_torch", "csrc"))
            and all(os.path.isfile(c) for c in (FLAGSHIP, TINY, LIDAR,
                                                 TINY_LIDAR))
            and all(os.path.isfile(os.path.join(HERE, "configs", f))
                    for f, _ in ZOO.values())):
        print("[chip_smoke] FAIL: run from the root of a lanemapping_tpu "
              "checkout (lanemapping_tpu_torch/ and configs/ beside this "
              "script)", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import torch
    if not torch.cuda.is_available():
        print("[chip_smoke] FAIL: no CUDA device (torch.cuda.is_available() "
              "is False)", file=sys.stderr)
        return 2
    t_start = time.perf_counter()

    def phase(n, fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        log(f"phase {n} ({fn.__name__}) wall {time.perf_counter() - t0:.3f} s")
        return out

    card, kind = phase(1, phase_card)
    phase(2, phase_build)
    from lanemapping_tpu_torch.data.synthetic import generate_dataset
    from lanemapping_tpu_torch.tools.las2bev import DEFAULT_PC_RANGE
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        root = os.path.join(tmp, "flagship")
        t0 = time.perf_counter()
        write_clouds(root, N_CLOUDS, IMG, N_POINTS, seed0=0)
        log(f"wrote {N_CLOUDS} clouds of {N_POINTS} points in "
            f"{time.perf_counter() - t0:.3f} s")
        k1 = phase(3, phase_k1, root, DEFAULT_PC_RANGE)
        k1["launches"], _ = phase(4, phase_slice, root,
                                  os.path.join(tmp, "out"))
        phase(5, phase_card_vs_cpu, os.path.join(tmp, "tiny"))

        lidar_root = os.path.join(tmp, "lidar")
        t0 = time.perf_counter()
        # every tile trains (2 batches of 8 per pass); the first 8 validate
        names = [f"{190000 + i:06d}_{i:04d}" for i in range(N_CLOUDS)]
        stems = generate_dataset(lidar_root, n_tiles=N_CLOUDS, img=IMG,
                                 seed=7, with_points=True,
                                 points_per_tile=N_POINTS, splits={
                                     "train": names, "valid": names[:B],
                                     "test": names[B:], "single": names[:1],
                                     "pretrain": names})
        check(stems == names, "the dataset's tile names changed")
        log(f"wrote a LaserLane dataset of {N_CLOUDS} tiles with clouds of "
            f"{N_POINTS} points in {time.perf_counter() - t0:.3f} s")
        k1z = phase(6, phase_k1z, lidar_root, stems, DEFAULT_PC_RANGE)
        k1z["launches"], _ = phase(7, phase_lidar_slice, lidar_root, stems,
                                   os.path.join(tmp, "out_lidar"))
        phase(8, phase_lidar_card_vs_cpu, os.path.join(tmp, "tiny_lidar"))

        train = phase(9, phase_train, "flagship training", FLAGSHIP,
                      lidar_root, os.path.join(tmp, "train_flagship"),
                      n_steps=8, lidar=False)
        k1["launches_train"] = train["launches"]["bev_bin_mean"]
        train = phase(10, phase_train, "lidar training", LIDAR, lidar_root,
                      os.path.join(tmp, "train_lidar"), n_steps=6,
                      lidar=True)
        k1z["launches_train"] = train["launches"]["voxel_bin_mean"]
        phase(11, phase_train_card_vs_cpu, os.path.join(tmp, "tiny_train"),
              os.path.join(tmp, "train_tiny"))

        serving = phase(12, phase_zoo_serving, lidar_root,
                        os.path.join(tmp, "zoo"))
        training = phase(13, phase_zoo_train, lidar_root,
                         os.path.join(tmp, "zoo_train"))
        for k in (k1, k1z):
            k["launches_zoo"] = {
                name: {"serving": serving[name][k["name"]],
                       "training": training[name][k["name"]]}
                for name in ZOO}
        phase(14, phase_zoo_card_vs_cpu, os.path.join(tmp, "tiny_zoo"),
              os.path.join(tmp, "zoo_tiny_logs"))

        map3d = phase(15, phase_map3d, lidar_root, stems, tmp)
        branches = phase(16, phase_branches, root, lidar_root, tmp)
        for k in (k1, k1z):
            k["launches_map3d"] = {path: c[k["name"]]
                                   for path, c in map3d.items()}
            k["launches_branches"] = {
                b: {how: c[k["name"]] for how, c in counts.items()}
                for b, counts in branches.items()}
        phase(17, phase_branch_card_vs_cpu, os.path.join(tmp, "tiny_branch"),
              os.path.join(tmp, "branch_tiny_logs"))
        zoo_models = phase(18, phase_zoo_models, root, lidar_root, tmp)
        k1["launches_zoo_models"] = {path: {how: c["bev_bin_mean"]
                                            for how, c in counts.items()}
                                     for path, counts in zoo_models.items()}
        phase(19, phase_zoo_models_card_vs_cpu, os.path.join(tmp, "tiny_zoo2"),
              os.path.join(tmp, "zoo2_tiny_logs"))
        phase(20, phase_dist_world_one, lidar_root, os.path.join(tmp, "dist1"))
        k1z["launches_dist_per_rank"] = phase(
            20, phase_dist_two_ranks, lidar_root, os.path.join(tmp, "dist2"))
        k1["launches_replicas"] = phase(21, phase_stream_replicas, root,
                                        os.path.join(tmp, "replicas"))
    log(f"all phases passed in {time.perf_counter() - t_start:.3f} s")
    print(card, flush=True)
    print(json.dumps({"kernels": [k1, k1z]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
