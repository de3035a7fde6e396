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

Phases 9 and 10 run with PyTorch's default precision flags (TF32
convolutions on).  Before the last line it prints ``{"kernels": [...]}``
(with each kernel's launches on the serving and the training path); the
last line is
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
    import torch
    from lanemapping_tpu_torch.config.config import Config
    from lanemapping_tpu_torch.models.nets import build_model
    from lanemapping_tpu_torch.ops.voxelize import bev_image_from_points
    from lanemapping_tpu_torch.tools import stream_map
    from lanemapping_tpu_torch.tools.las2bev import las2bev_params

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

    # every head map of one batch through the same modules: finite, shaped
    cfg = Config.fromfile(FLAGSHIP)
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
    want = head_shapes(S, P)
    check(set(out) == set(want), f"head keys {sorted(out)}")
    for k, shape in want.items():
        check(tuple(out[k].shape) == shape, f"{k} shape {tuple(out[k].shape)}")
        check(bool(torch.isfinite(out[k]).all()), f"{k} is not finite")
    check(bool(torch.isfinite(x).all()), "BEV tile is not finite")
    log("slice head maps finite with the expected shapes")
    return launches, rec


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


def check_lane_jsons(lanes_dir, n_tiles):
    import numpy as np
    names = sorted(os.listdir(lanes_dir))
    check(len(names) == n_tiles, f"{len(names)} lane JSONs written")
    n_lanes = 0
    for n in names:
        with open(os.path.join(lanes_dir, n)) as f:
            recs = json.load(f)
        for r in recs:
            seq = np.asarray(r["seq"], np.float64)
            check(np.isfinite(seq).all(), f"{n}: non-finite lane vertex")
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


def main():
    if not (os.path.isdir(os.path.join(HERE, "lanemapping_tpu_torch", "csrc"))
            and all(os.path.isfile(c) for c in (FLAGSHIP, TINY, LIDAR,
                                                 TINY_LIDAR))):
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
    card, kind = phase_card()
    phase_build()
    from lanemapping_tpu_torch.data.synthetic import generate_dataset
    from lanemapping_tpu_torch.tools.las2bev import DEFAULT_PC_RANGE
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        root = os.path.join(tmp, "flagship")
        t0 = time.perf_counter()
        write_clouds(root, N_CLOUDS, IMG, N_POINTS, seed0=0)
        log(f"wrote {N_CLOUDS} clouds of {N_POINTS} points in "
            f"{time.perf_counter() - t0:.3f} s")
        k1 = phase_k1(root, DEFAULT_PC_RANGE)
        k1["launches"], _ = phase_slice(root, os.path.join(tmp, "out"))
        phase_card_vs_cpu(os.path.join(tmp, "tiny"))

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
        k1z = phase_k1z(lidar_root, stems, DEFAULT_PC_RANGE)
        k1z["launches"], _ = phase_lidar_slice(
            lidar_root, stems, os.path.join(tmp, "out_lidar"))
        phase_lidar_card_vs_cpu(os.path.join(tmp, "tiny_lidar"))

        train = phase_train("flagship training", FLAGSHIP, lidar_root,
                            os.path.join(tmp, "train_flagship"),
                            n_steps=8, lidar=False)
        k1["launches_train"] = train["launches"]["bev_bin_mean"]
        train = phase_train("lidar training", LIDAR, lidar_root,
                            os.path.join(tmp, "train_lidar"), n_steps=6,
                            lidar=True)
        k1z["launches_train"] = train["launches"]["voxel_bin_mean"]
        phase_train_card_vs_cpu(os.path.join(tmp, "tiny_train"),
                                os.path.join(tmp, "train_tiny"))
    log(f"all phases passed in {time.perf_counter() - t_start:.3f} s")
    print(card, flush=True)
    print(json.dumps({"kernels": [k1, k1z]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
