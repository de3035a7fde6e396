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
   2e-3, the same lane records (columns to 1e-3 px).

Before the last line it prints ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

import copy
import json
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
        stems = generate_dataset(lidar_root, n_tiles=N_CLOUDS, img=IMG,
                                 seed=7, with_points=True,
                                 points_per_tile=N_POINTS)
        log(f"wrote a LaserLane dataset of {N_CLOUDS} tiles with clouds of "
            f"{N_POINTS} points in {time.perf_counter() - t0:.3f} s")
        k1z = phase_k1z(lidar_root, stems, DEFAULT_PC_RANGE)
        k1z["launches"], _ = phase_lidar_slice(
            lidar_root, stems, os.path.join(tmp, "out_lidar"))
        phase_lidar_card_vs_cpu(os.path.join(tmp, "tiny_lidar"))
    log(f"all phases passed in {time.perf_counter() - t_start:.3f} s")
    print(card, flush=True)
    print(json.dumps({"kernels": [k1, k1z]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
