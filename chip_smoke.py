#!/usr/bin/env python3
"""Chip smoke test of ``lanemapping_tpu_torch`` on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Run from the root of a checkout.  It imports nothing of JAX nor of the JAX
package, and fails (non-zero exit, no result line) without a CUDA device
or outside a checkout.  Phases, each of which fails the run:

1. card: ``nvidia-smi`` name and power limit, ``torch.cuda`` device name;
2. build K1 (``lanemapping_tpu_torch/csrc/bev_bin.cu``) with ``nvcc`` from
   the checkout's sources, printing the build time and ``-Xptxas -v``;
3. K1 against its plain PyTorch version on the card at the slice's shapes
   (8 seeded lane-structured clouds of 2^19 points, 1152^2 grid): counts
   exactly equal, sums within rtol 1e-5 / atol 1e-5; CUDA-event times of
   the kernel, the plain version and one ``index_put_(accumulate=True)``
   call (the library yardstick, used nowhere in the port), beside the
   bound (bytes moved over 3.35 TB/s);
4. the slice at full width: 16 seeded ``.las`` clouds of 2^19 points ->
   ``tools/stream_map --from-las`` on the flagship config
   (``configs/Proj_polyline_fpn_vit_vertex_2.py``), seeded random weights,
   bf16, batch 8 -> one lane JSON per tile; K1's launch count is zeroed
   just before and read just after, and must be > 0; every head map of a
   batch is finite and of the expected shape;
5. the port on the card against the port on the CPU at
   ``configs/tiny_test.py`` in float32 with TF32 off: every head map within
   rel-max 2e-3, the same lane records (columns to 1e-3 px).

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
B, N_POINTS, IMG = 8, 1 << 19, 1152
N_CLOUDS = 16
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet, at the 700 W limit
FP32_OPS_PER_S = 67e12     # H100 SXM float32 outside the tensor cores


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(msg):
    print(f"[chip_smoke] {msg}", flush=True)


def cuda_ms(fn, iters=20, warmup=3):
    """Mean milliseconds per call from CUDA events around ``iters`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


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


def phase_build():
    from lanemapping_tpu_torch.kernels import build
    t0 = time.perf_counter()
    built = build.build_all(["bev_bin"], force=True)
    log(f"K1 build {time.perf_counter() - t0:.3f} s (nvcc "
        f"{' '.join(build.NVCC_FLAGS)})")
    for name, rec in built.items():
        log(f"{name}: nvcc {rec['seconds']:.3f} s; ptxas:\n{rec['ptxas']}")
    check(os.path.isfile(os.path.join(build.BUILD_DIR, "libbev_bin.so")),
          "libbev_bin.so missing after the build")


def phase_k1(root, pc_range):
    import numpy as np
    import torch
    from lanemapping_tpu_torch.kernels.bev_bin import (bev_bin_sums,
                                                       bev_bin_sums_ref,
                                                       bin_geometry)
    pts_np, msk_np = load_batch(root, [f"tile{i:03d}" for i in range(B)],
                                N_POINTS)
    pts = torch.from_numpy(pts_np).cuda()
    msk = torch.from_numpy(msk_np).cuda()
    s, c = bev_bin_sums(pts, msk, pc_range, IMG, flip_rows=True)
    s_ref, c_ref = bev_bin_sums_ref(pts, msk, pc_range, IMG, flip_rows=True)
    torch.cuda.synchronize()
    cnt_mismatch = int((c != c_ref).sum())
    max_abs_err = float((s - s_ref).abs().max())
    sums_ok = bool(torch.allclose(s, s_ref, rtol=1e-5, atol=1e-5))
    n_valid = int(c_ref.sum())
    log(f"K1 vs plain: {n_valid} binned points, cnt_mismatch {cnt_mismatch}, "
        f"max_abs_err sums {max_abs_err:.3e}, allclose {sums_ok}")
    check(cnt_mismatch == 0, f"K1 counts differ in {cnt_mismatch} cells")
    check(sums_ok, f"K1 sums differ: max abs err {max_abs_err}")

    # the library yardstick: one index_put_ of (value, 1) rows on indices
    # precomputed outside the timed call
    lo, size = bin_geometry(pc_range, IMG)
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
    kernel = lambda: bev_bin_sums(pts, msk, pc_range, IMG, flip_rows=True)
    plain = lambda: bev_bin_sums_ref(pts, msk, pc_range, IMG, flip_rows=True)
    times = {"kernel": [], "plain": [], "library": []}
    for name in ("kernel", "plain", "library", "library", "plain", "kernel"):
        times[name].append(cuda_ms({"kernel": kernel, "plain": plain,
                                    "library": library}[name]))
    ms = {k: float(np.mean(v)) for k, v in times.items()}
    n_bytes = pts.numel() * 4 + msk.numel() + 2 * B * IMG * IMG * 4
    n_ops = 6 * B * N_POINTS  # 2 sub, 2 div, 2 atomic adds per point
    bound_ms = max(n_bytes / HBM_BYTES_PER_S, n_ops / FP32_OPS_PER_S) * 1e3
    log(f"K1 kernel {ms['kernel']:.4f} ms, plain {ms['plain']:.4f} ms, "
        f"index_put_ {ms['library']:.4f} ms, bound {bound_ms:.4f} ms "
        f"({n_bytes / 1e6:.1f} MB at 3.35 TB/s); runs {times}")
    return {"name": "bev_bin_sums", "route": "cuda",
            "source": "lanemapping_tpu_torch/csrc/bev_bin.cu",
            "replaces": "tests/pallas_reference_bev.py:111",
            "launches": None, "max_abs_err": max_abs_err,
            "ms": ms["kernel"], "plain_ms": ms["plain"],
            "bound_ms": bound_ms, "bound_by": "bytes",
            "library_ms": ms["library"], "kernel_ms": ms["kernel"],
            "max_abs_err_sums": max_abs_err, "cnt_mismatch": cnt_mismatch}


def phase_slice(root, out_dir):
    import numpy as np
    import torch
    from lanemapping_tpu_torch.config.config import Config
    from lanemapping_tpu_torch.kernels.bev_bin import bev_bin_sums
    from lanemapping_tpu_torch.models.nets import build_model
    from lanemapping_tpu_torch.ops.voxelize import bev_image_from_points
    from lanemapping_tpu_torch.tools import stream_map
    from lanemapping_tpu_torch.tools.las2bev import las2bev_params

    bev_bin_sums.launches = 0
    rec = stream_map.main([FLAGSHIP, root, "--from-las", "--batch", str(B),
                           "--out", out_dir, "--seed", "0", "--bench-json"])
    launches = bev_bin_sums.launches
    log(f"slice: K1 launches {launches}")
    check(launches > 0, "the main path never launched K1")
    check(rec["n_tiles"] == N_CLOUDS, f"{rec['n_tiles']} tiles streamed")
    names = sorted(os.listdir(rec["lanes_dir"]))
    check(len(names) == N_CLOUDS, f"{len(names)} lane JSONs written")
    n_lanes = 0
    for n in names:
        with open(os.path.join(rec["lanes_dir"], n)) as f:
            recs = json.load(f)
        for r in recs:
            seq = np.asarray(r["seq"], np.float64)
            check(np.isfinite(seq).all(), f"{n}: non-finite lane vertex")
        n_lanes += len(recs)
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
    want = {"semantic_seg": (B, IMG, IMG, 3), "endp_est": (B, IMG, IMG, 1),
            "orient": (B, S, S, 11), "proposal_conf": (B, P, 2),
            "ext2": (B, P, S, 3), "cls2": (B, P, S, 10),
            "offset2": (B, P, S, 10), "prop_seg_small": (B, P, 2 * S, 20)}
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


def main():
    if not (os.path.isdir(os.path.join(HERE, "lanemapping_tpu_torch", "csrc"))
            and os.path.isfile(FLAGSHIP) and os.path.isfile(TINY)):
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
    log(f"all phases passed in {time.perf_counter() - t_start:.3f} s")
    print(card, flush=True)
    print(json.dumps({"kernels": [k1]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
