"""Headline benchmarks of one card (port of the root `bench.py`): BEV-tile
serving throughput, and with ``--train`` the full-size training step.

    python -m lanemapping_tpu_torch.tools.bench [--batch 64] [--iters 8]
    python -m lanemapping_tpu_torch.tools.bench --train [--config PATH] \\
        [--batch 8] [--iters 4] [--no-remat] [--remat-policy full|dots] \\
        [--no-fused-seg] [--seg-chunks 1] [--lidar-points 131072] \\
        [--set "k=v;k=v"] [--analyze-only]

Each mode prints ONE JSON line, the root script's record less its TPU
keys, with the card's name and power limit (``nvidia-smi``) beside it.

Serving (``main`` of the root script): the flagship at seeded random
weights, every floating parameter and buffer (BatchNorm statistics
included) cast to the config's compute dtype, forward plus the device
decode (`decode/lane_decode.py::decode_lanes`) on a ``[batch, 1152, 1152,
3]`` uniform tile batch, a ``[batch]`` digest of the decode (``cls_offset``
+ ``prop_conf`` + ``endp_coords`` means) folded into the next pass's input
so the passes stay chained.  ``--warmup`` passes, then ``--iters`` passes
between CUDA events under ``torch.inference_mode``; tiles/s over those.
``hbm_highwater_gb`` is ``max_memory_allocated`` (GiB) after
``reset_peak_memory_stats`` with the weights and the input resident.

Training (``--train``, ``main_train`` there): the port's
`engine/state.py::make_train_step` at bf16 with
`models/head_losses.py::column_proposal_loss` and the config's optimizer,
on a batch drawn from ``np.random.RandomState(0)`` by the root script's
recipe and resident on the card; one warm-up step, then ``--iters`` steps
between CUDA events (each step reads its loss on the host for the NaN
guard, as every training step of the port does).  A LiDAR config
(``use_lidar``) trains on ``--lidar-points`` uniform points a cloud over
``lidar_point_cloud_range`` through the K1z voxelizer; the record carries
its launches, the warm-up step's included.  ``--analyze-only`` reports the
step's model FLOPs and memory high-water after one untimed step.

``step_flops`` is the MODEL's count (`count_model_flops`): convolutions
and matmuls of the forward, the loss and the backward, counted by
``torch.utils.flop_counter.FlopCounterMode`` on the ``meta`` device
through the plain path, without rematerialisation, so no kernel and no
remat policy moves it.  ``train_mfu`` is that count over s/step over the
card's dense bf16 peak (``CARD_PEAKS``; an unknown card raises).  On the
CPU (``--device cpu``, for tests) the times are the host clock's and the
shares are null.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import os
import time
from typing import Dict, Optional
from unittest import mock

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
FLAGSHIP = os.path.join(REPO, "configs", "Proj_polyline_fpn_vit_vertex_2.py")

# Derived in BASELINE.md ("Derivation of the 25 tiles/s RTX-4090
# denominator", tools/derive_baseline.py -> BASELINE_DERIVATION.json): an
# estimate for the reference model on an RTX 4090, not a measurement.
BASELINE_4090_TILES_PER_SEC = 25.0
# Published dense peaks by `torch.cuda.get_device_name`: NVIDIA's data
# sheet of the H100 SXM part (700 W), without sparsity.
CARD_PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops_per_s": 989e12,
                              "hbm_bytes_per_s": 3.35e12},
}
CONV_OPS = ("aten.convolution", "aten.convolution_backward",
            "aten._convolution")


def card_peak(device: torch.device) -> Optional[Dict[str, float]]:
    """The card's published peaks (``CARD_PEAKS``); None on the CPU.  A
    card missing from the table raises: a share of an unknown peak would
    be a guess."""
    if device.type != "cuda":
        return None
    name = torch.cuda.get_device_name(device)
    if name not in CARD_PEAKS:
        raise KeyError(f"no published peak for {name!r} in CARD_PEAKS; add "
                       "the card's dense bf16 FLOP/s and memory rate")
    return CARD_PEAKS[name]


def elapsed_ms(device: torch.device, fn, n: int) -> float:
    """Milliseconds of ``n`` calls of ``fn``: CUDA events around them on a
    card (synchronised), the host clock on the CPU."""
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        return (time.perf_counter() - t0) * 1e3
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize(device)
    return a.elapsed_time(b)


def reset_peak(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)


def peak_gib(device: torch.device) -> Optional[float]:
    """``max_memory_allocated`` in GiB (2^30, as the root script's
    ``hbm_highwater_gb``); None on the CPU."""
    if device.type != "cuda":
        return None
    return round(torch.cuda.max_memory_allocated(device) / 2 ** 30, 3)


# -- the model's FLOPs ---------------------------------------------------------

def _dims(cfg):
    img = cfg.list_img_size_xy[0]
    W = cfg.heads.prop_width + 2 * cfg.heads.prop_half_buff
    return img, cfg.heads.row_size, cfg.heads.num_prop, W


def _zfold_stand_in(points, mask, pc_range, grid, max_points_per_voxel=None):
    """The z-fold plane's shape and dtype, without binning: the voxelizer
    does no convolution or matmul, and its kernel takes no meta tensor."""
    X, Y, Z = grid
    return points.new_zeros((points.shape[0], Y, X, Z * points.shape[-1]),
                            dtype=torch.float32)


def count_model_flops(cfg, batch: int, train: bool,
                      device: str = "meta") -> Dict:
    """The model FLOPs of one forward (``train=False``) or one training
    step (``train=True``: the train-mode forward, the column-proposal loss
    and the backward) at ``batch`` tiles of ``cfg``, counted by
    ``FlopCounterMode`` on ``device`` (``meta`` by default: nothing runs,
    no memory is taken) through the plain path with remat off.

    Returns ``{"total", "conv", "matmul", "by_op", "flops_method"}``.  Where
    the loss cannot run on ``meta`` the training count is 3x the forward,
    and ``flops_method`` says so.  On a LiDAR config the voxelizer, which
    has no convolution or matmul, is replaced on ``meta`` by a zero plane
    of its output's shape."""
    from torch.utils.flop_counter import FlopCounterMode

    from ..engine.state import model_input
    from ..models import head_losses, lidar_encoder
    from ..models.nets import build_model

    cfg = copy.deepcopy(cfg)
    cfg.remat = False
    use_lidar = bool(cfg.get("use_lidar", False))
    model = build_model(cfg).to(device).train(train)
    # the training batch's keys, shapes and dtypes, from one drawn tile
    db = {k: torch.zeros((batch,) + v.shape[1:], dtype=v.dtype,
                         device=device)
          for k, v in train_batch(cfg, 1, np.random.RandomState(0)).items()}
    if not use_lidar:
        db["proj"] = db["proj"].float()  # the count does not read dtypes
    inp = model_input(db, use_lidar)
    patch = mock.patch.object(lidar_encoder, "voxelize_bev_zfold",
                              _zfold_stand_in) \
        if use_lidar and device == "meta" else contextlib.nullcontext()

    grad = contextlib.nullcontext() if train else torch.no_grad()
    with patch, grad, FlopCounterMode(display=False) as fwd:
        out = model(inp)
    counts = dict(fwd.get_flop_counts()["Global"])
    method = ("FlopCounterMode on %s, plain path, remat off: %s" % (
        device, "train-mode forward + column_proposal_loss + backward"
        if train else "eval-mode forward"))
    if train:
        try:
            with FlopCounterMode(display=False) as rest:
                head_losses.column_proposal_loss(
                    out, db, head_losses.head_hparams(cfg))["loss"].backward()
            for k, v in rest.get_flop_counts()["Global"].items():
                counts[k] = counts.get(k, 0) + v
        except (RuntimeError, NotImplementedError) as e:
            counts = {k: 3 * v for k, v in counts.items()}
            method = (f"3x the train-mode forward (FlopCounterMode on "
                      f"{device}, remat off): the loss does not run on "
                      f"{device} ({type(e).__name__}: {str(e)[:120]})")
    by_op = {str(k): int(v) for k, v in counts.items()}
    conv = sum(v for k, v in by_op.items() if k in CONV_OPS)
    total = sum(by_op.values())
    return {"total": total, "conv": conv, "matmul": total - conv,
            "by_op": by_op, "flops_method": method}


# -- serving ---------------------------------------------------------------------

def make_pass(model: torch.nn.Module, cfg, dtype: torch.dtype):
    """``one_pass(p) -> [B]`` digest of the forward at ``dtype`` and the
    device decode of a float32 NHWC batch (the root script's
    ``one_pass``)."""
    from ..decode.lane_decode import decode_lanes

    def one_pass(p: torch.Tensor) -> torch.Tensor:
        dec = decode_lanes(model(p.to(dtype)), cfg)
        return (dec["cls_offset"].mean(dim=(1, 2))
                + dec["prop_conf"].mean(dim=(1, 2))
                + dec["endp_coords"].mean(dim=(1, 2)))
    return one_pass


def serving_model(cfg, device: torch.device):
    """(model, compute dtype): the config's net at seed-0 random weights on
    ``device``, every floating parameter and buffer cast to
    ``cfg.compute_dtype`` (the root script casts every float32 leaf of the
    flax variables, BatchNorm statistics included), channels-last on a
    card."""
    from ..models.nets import build_model

    dtype = torch.bfloat16 if cfg.get("compute_dtype") == "bfloat16" \
        else torch.float32
    model = build_model(cfg, seed=0).to(device=device, dtype=dtype)
    if device.type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    return model, dtype


def serve(args, device: torch.device) -> Dict:
    from ..config.config import Config

    cfg = Config.fromfile(args.config)
    if cfg.get("use_lidar", False):
        raise SystemExit("[bench] serving benchmarks BEV image tiles; a "
                         "LiDAR config trains with --train")
    batch = args.batch or 64
    iters = args.iters or 8
    img = cfg.list_img_size_xy[0]
    peak = card_peak(device)
    model, dtype = serving_model(cfg, device)
    gen = torch.Generator(device=device).manual_seed(0)
    proj = torch.rand((batch, img, img, 3), generator=gen, device=device)
    one_pass = make_pass(model, cfg, dtype)
    carry = [torch.zeros(batch, device=device)]

    def run():
        # the digest folded into the input chains the passes
        carry[0] = one_pass(proj + (carry[0] * 1e-24)[:, None, None, None])

    reset_peak(device)
    with torch.inference_mode():
        for _ in range(args.warmup):
            run()
        ms = elapsed_ms(device, run, iters)
    digest = carry[0].float().cpu().numpy()
    if not np.isfinite(digest).all():
        raise RuntimeError(f"[bench] non-finite digest {digest}")
    tiles_per_sec = batch * iters / (ms / 1e3)
    flops = count_model_flops(cfg, batch, train=False)
    record = {
        "metric": "bev_tiles_per_sec_per_chip",
        "value": round(tiles_per_sec, 2),
        "unit": "tiles/s",
        "vs_baseline": round(tiles_per_sec / BASELINE_4090_TILES_PER_SEC, 2),
        "baseline_estimated": True,
        "baseline_assumption": f"RTX-4090 {BASELINE_4090_TILES_PER_SEC} "
                               "tiles/s derived denominator (BASELINE.md "
                               "derivation + BASELINE_DERIVATION.json: "
                               "measured-serial reference harness ~6.6, "
                               "pure-GPU roofline 41-76; 25 = generous "
                               "pipelined-deployment middle)",
        "hbm_highwater_gb": peak_gib(device),
        "batch": batch, "img": img, "iters": iters, "warmup": args.warmup,
        "compute_dtype": str(dtype).replace("torch.", ""),
        "ms_per_pass": ms / iters,
        "forward_flops": flops["total"],
        "mfu": (flops["total"] * iters / (ms / 1e3)
                / peak["bf16_flops_per_s"]) if peak else None,
        "flops_method": flops["flops_method"],
        "digest_mean": float(digest.mean()),
    }
    if args.e2e_json:
        # a record of the port's own `tools/stream_bench.py`
        with open(args.e2e_json) as f:
            e2e = json.load(f)
        record["e2e_tiles_per_sec_per_chip"] = e2e.get("value")
        record["km_lane_per_hour"] = e2e.get("km_lane_per_hour")
        record["e2e_source"] = os.path.abspath(args.e2e_json)
    return record


# -- training --------------------------------------------------------------------

def train_config(args):
    """The config of a ``--train`` run: ``--config`` with bf16 training,
    the flags' remat, fused seg focal and chunks, ``--set`` overrides
    (``"k=v;k=v"``), and a LiDAR config's ``max_points``."""
    from ..config.config import Config, parse_dict_action

    cfg = Config.fromfile(args.config)
    cfg.train_compute_dtype = "bfloat16"
    cfg.remat = args.remat
    cfg.remat_policy = args.remat_policy
    cfg.fused_seg_focal = not args.no_fused_seg
    cfg.seg_focal_chunks = args.seg_chunks
    if args.set:
        cfg.merge_from_dict(parse_dict_action(args.set.split(";")))
    if cfg.get("use_lidar", False):
        cfg.max_points = args.lidar_points
    return cfg


def train_batch(cfg, B: int, rng: np.random.RandomState
                ) -> Dict[str, torch.Tensor]:
    """The root script's training batch (`bench.py:100-129`), drawn from
    ``rng`` in its order, as CPU tensors in its dtypes (bf16 for the tile
    and the endpoint map):
    uniform LiDAR clouds over ``lidar_point_cloud_range`` (intensity
    800-33000) or a uniform bf16 tile, then the proposal labels, a sparse
    endpoint map and the fused seg focal's instance map (or the unfused
    binary maps)."""
    img, S, P, W = _dims(cfg)
    bf16 = torch.bfloat16
    if cfg.get("use_lidar", False):
        n = cfg.max_points
        rng_ = list(cfg.lidar_point_cloud_range)
        lo = np.array(rng_[:3] + [800.0], np.float32)
        hi = np.array(rng_[3:] + [33000.0], np.float32)
        pts = lo + rng.rand(B, n, 4).astype(np.float32) * (hi - lo)
        inp = {"points": torch.from_numpy(pts),
               "points_mask": torch.ones((B, n), dtype=torch.bool)}
    else:
        inp = {"proj": torch.from_numpy(rng.rand(B, img, img, 3)).to(bf16)}
    batch = {
        **inp,
        "prop_ext": rng.randint(0, 3, (B, P, S)).astype(np.uint8),
        "prop_coor": rng.uniform(-1, W, (B, P, S)).astype(np.float32),
        "prop_offset": rng.randn(B, P, S, W).astype(np.float32),
        "prop_offset_mask": rng.randint(0, 2, (B, P, S, W)).astype(
            np.float32),
        "lc_orient": rng.randint(0, 11, (B, S, S)).astype(np.uint8),
        "semantic_label_raw": rng.randint(0, 3, (B, img, img)).astype(
            np.uint8),
        "endp_map": torch.from_numpy(np.where(
            rng.rand(B, img, img) > 0.999, rng.rand(B, img, img),
            0)).to(bf16),
    }
    if cfg.get("fused_seg_focal", True):
        batch["prop_inst"] = np.where(
            rng.rand(B, img, img) < 0.01,
            rng.randint(0, 12, (B, img, img)), 255).astype(np.uint8)
        batch["prop_best"] = rng.randint(0, 12, (B, P)).astype(np.uint8)
    else:
        batch["prop_bi_seg"] = rng.randint(
            0, 2, (B, P, img, 8 * W)).astype(np.uint8)
    return {k: v if isinstance(v, torch.Tensor) else torch.from_numpy(v)
            for k, v in batch.items()}


def build_train(cfg, B: int, device: torch.device):
    """(train state, step, device batch) of the training benchmark, shared
    with `tools/profile_train.py`: the config's net at seed-0 random
    weights on ``device`` (channels-last on a card), its optimizer and
    schedule, the bf16 step with the column-proposal loss, and
    `train_batch` of ``RandomState(0)`` resident on ``device``."""
    from ..engine.state import create_train_state, make_train_step
    from ..models.head_losses import column_proposal_loss, head_hparams
    from ..models.nets import build_model

    model = build_model(cfg, seed=0).to(device)
    if device.type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    state = create_train_state(model, cfg)
    hp = head_hparams(cfg)
    step = make_train_step(lambda out, b: column_proposal_loss(out, b, hp),
                           torch.bfloat16,
                           bool(cfg.get("use_lidar", False)))
    batch = {k: v.to(device) for k, v in
             train_batch(cfg, B, np.random.RandomState(0)).items()}
    return state, step, batch


def _checked(stats: Dict) -> float:
    loss = float(stats["loss"])
    if not np.isfinite(loss) or stats["skipped_nan"]:
        raise RuntimeError(f"[bench] non-finite training loss {loss}")
    return loss


def train(args, device: torch.device) -> Dict:
    from ..kernels.voxel_bin import voxel_bin_mean

    cfg = train_config(args)
    B = args.batch or 8
    iters = args.iters or 4
    img = cfg.list_img_size_xy[0]
    use_lidar = bool(cfg.get("use_lidar", False))
    peak = card_peak(device)
    flops = count_model_flops(cfg, B, train=True)
    state, step, batch = build_train(cfg, B, device)

    reset_peak(device)
    voxel_bin_mean.launches = 0
    _checked(step(state, batch))  # warm-up: cuDNN's autotune, K1z's build
    if args.analyze_only:
        hbm = peak_gib(device)
        return {"metric": "train_step_analysis", "batch": B, "img": img,
                "remat": cfg.remat,
                "remat_policy": cfg.remat_policy if cfg.remat else None,
                "step_flops": flops["total"], "hbm_highwater_gb": hbm,
                "flops_method": flops["flops_method"],
                "launches": {"voxel_bin_mean": voxel_bin_mean.launches}}
    losses = []
    ms = elapsed_ms(device, lambda: losses.append(
        _checked(step(state, batch))), iters)
    sec_per_step = ms / 1e3 / iters
    mfu = flops["total"] / sec_per_step / peak["bf16_flops_per_s"] \
        if peak else None
    return {
        "metric": "train_sec_per_step",
        "value": round(sec_per_step, 5),
        "unit": "s/step",
        "batch": B,
        "img": img,
        "use_lidar": use_lidar,
        "lidar_points": cfg.max_points if use_lidar else None,
        "fused_seg_focal": cfg.fused_seg_focal,
        "seg_focal_chunks": cfg.seg_focal_chunks,
        "remat": cfg.remat,
        "remat_policy": cfg.remat_policy if cfg.remat else None,
        "step_flops": flops["total"],
        "step_flops_conv": flops["conv"],
        "step_flops_matmul": flops["matmul"],
        "flops_method": flops["flops_method"],
        "hbm_highwater_gb": peak_gib(device),
        "train_mfu": round(mfu, 5) if mfu is not None else None,
        "tiles_per_sec_train": round(B / sec_per_step, 3),
        "iters": iters,
        "losses": losses,
        "launches": {"voxel_bin_mean": voxel_bin_mean.launches},
    }


# -- CLI ---------------------------------------------------------------------------

def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--train", action="store_true",
                    help="benchmark the training step instead of serving")
    ap.add_argument("--config", default=FLAGSHIP)
    ap.add_argument("--batch", type=int, default=None,
                    help="tiles a batch (serving 64, training 8)")
    ap.add_argument("--iters", type=int, default=None,
                    help="timed passes (serving 8) or steps (training 4)")
    ap.add_argument("--warmup", type=int, default=2,
                    help="serving passes before the timed ones")
    ap.add_argument("--remat", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--remat-policy", default="full",
                    choices=("full", "dots"))
    ap.add_argument("--no-fused-seg", action="store_true")
    ap.add_argument("--seg-chunks", type=int, default=1)
    ap.add_argument("--lidar-points", type=int, default=1 << 17)
    ap.add_argument("--set", default="",
                    help='semicolon-separated config overrides, "k=v;k=v"')
    ap.add_argument("--analyze-only", action="store_true",
                    help="--train: FLOPs and memory after one untimed step")
    ap.add_argument("--e2e-json", default=None,
                    help="a record of tools/stream_bench.py to quote")
    ap.add_argument("--out", default=None, help="also write the record here")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> Dict:
    from ..api import resolve_device
    from .soak_run import card_provenance

    args = parse_args(argv)
    device = resolve_device(args.device)
    record = (train if args.train else serve)(args, device)
    record.update(card_provenance(device))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main()
