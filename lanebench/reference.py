"""The plain reference at work: what the timed path should have produced
for the sampled tiles, and the first three training steps, computed by
the frozen plain model (`lanebench/plain`) from the benchmark's own
inputs and weights, never from anything the program made.  Each runs
after the window has closed and the program's state is freed."""

from __future__ import annotations

import copy
from typing import Dict, List, Sequence

import numpy as np
import torch

from .precision import (activation_dtype, e4m3, hook_inputs,
                        strict_float32, weights_at, _matmul_modules)


def _cfg(cfg: Dict):
    from .plain import ConfigDict
    return ConfigDict(copy.deepcopy(cfg))


def plain_model(cfg: Dict, sd: Dict[str, torch.Tensor],
                device: torch.device) -> torch.nn.Module:
    from .plain import build_model
    model = build_model(cfg).to(device)
    model.load_state_dict(sd)
    return model


# -- serving -------------------------------------------------------------------

def serving_model(cfg: Dict, sd, device, level: str) -> torch.nn.Module:
    """The served net at ``level``: below float32 every weight and buffer
    in bf16, and under float8 the convolution and linear weights on the
    e4m3 grid."""
    model = plain_model(cfg, sd, device).eval()
    if level != "float32":
        model = model.to(torch.bfloat16)
    if level == "float8":
        with torch.no_grad():
            for m in _matmul_modules(model):
                m.weight.copy_(e4m3(m.weight))
    return model


def bev_tiles(cfg: Dict, points: torch.Tensor, mask: torch.Tensor
              ) -> torch.Tensor:
    """The BEV tiles [B, img, img] float32 of raw clouds, as the survey
    rasterizer defines them (mean intensity a cell, holes filled,
    calibrated)."""
    from .plain.ops.voxelize import bev_image_from_points
    p = cfg["las2bev"]
    return bev_image_from_points(points, mask, p["pc_range"],
                                 cfg["list_img_size_xy"][0], gain=p["gain"],
                                 bias=p["bias"], fill_iters=p["fill_iters"])


def serve_tiles(cfg: Dict, sd, points: torch.Tensor, mask: torch.Tensor,
                level: str) -> List[Dict[str, torch.Tensor]]:
    """Per tile of [T, N, 4] clouds (intensity normalised) and [T, N]
    masks on the device: ``input`` (the BEV tile [img, img]) and ``out``
    (the head outputs, float32), one tile at a time."""
    model = serving_model(cfg, sd, points.device, level)
    hs = hook_inputs(model, level)
    res = []
    with strict_float32(), torch.no_grad():
        for t in range(len(points)):
            bev = bev_tiles(cfg, points[t:t + 1], mask[t:t + 1])
            if level == "float8":
                bev = e4m3(bev)
            x = bev.to(activation_dtype(level))[..., None]
            out = model(x.expand(*x.shape[:-1], 3).contiguous())
            inp = x[0, ..., 0].float()
            res.append({"input": inp,
                        "out": {k: v[0].float() for k, v in out.items()}})
    for h in hs:
        h.remove()
    del model
    return res


def decode_view(out: Dict[str, torch.Tensor], cfg: Dict) -> Dict:
    """The decode the host postprocess reads, as the served stream ships
    it: confidence rows as uint8, extents uint8, orientations int8."""
    from .plain.decode.lane_decode import decode_lanes, host_decode_view

    c = _cfg(cfg)
    keep = host_decode_view(decode_lanes(out, c))
    if not c.get("view_detail", False):
        keep.pop("cls", None)
        keep.pop("cls_exp", None)
    keep["bi_seg_rows"] = torch.round(torch.clamp(
        keep["bi_seg_rows"], 0.0, 1.0) * 255.0).to(torch.uint8)
    keep["prop_v_ext"] = keep["prop_v_ext"].to(torch.uint8)
    keep["orient"] = keep["orient"].to(torch.int8)
    return keep


def lane_records(dec: Dict[str, np.ndarray], cfg: Dict) -> List[List[Dict]]:
    """The lane JSON records of each tile of a host decode: the NumPy
    tracker, NMS and semantics, then the records as the export writes
    them."""
    from .plain.decode.postprocess import lane_maps_from_decode

    maps = lane_maps_from_decode(dec, _cfg(cfg))
    out = []
    for ply in maps["cls_offset_smooth"]:
        recs = []
        for li in range(len(ply)):
            rows = np.nonzero(ply[li, :, 0] > 0)[0]
            if len(rows) < 2:
                continue
            verts = [[int(r * 8 + 3), float(ply[li, r, 0]),
                      int(ply[li, r, 1])] for r in rows]
            recs.append({"lane_id": int(li), "seq_len": len(verts),
                         "init_vertex": verts[0][:2],
                         "end_vertex": verts[-1][:2], "seq": verts})
        out.append(recs)
    return out


def records_differ(a: List[Dict], b: List[Dict], tol: float = 1e-6) -> bool:
    """Whether two tiles' lane records differ: the same lanes, vertex rows
    and semantics, and vertex columns within ``tol`` px."""
    if len(a) != len(b):
        return True
    for ra, rb in zip(a, b):
        if (ra["lane_id"], ra["seq_len"]) != (rb["lane_id"], rb["seq_len"]):
            return True
        va, vb = np.asarray(ra["seq"], np.float64), \
            np.asarray(rb["seq"], np.float64)
        if va.shape != vb.shape or np.any(va[:, [0, 2]] != vb[:, [0, 2]]) \
                or np.max(np.abs(va[:, 1] - vb[:, 1]), initial=0.0) > tol:
            return True
    return False


def rel_l2(p: torch.Tensor, r: torch.Tensor) -> float:
    r = r.double()
    return float(torch.linalg.vector_norm(p.double() - r)
                 / torch.linalg.vector_norm(r).clamp(min=1e-30))


def head_gap(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor]
             ) -> float:
    """The worst output's relative L2 distance from the reference."""
    return max(rel_l2(prog[k].float(), ref[k]) for k in ref)


def batch_head_gap(prog: Dict[str, torch.Tensor],
                   ref: Dict[str, torch.Tensor]) -> float:
    """``head_gap`` over a batch's outputs, a tile the program left out
    counted as an output of zeros."""
    full = {}
    for k, r in ref.items():
        p = prog[k].to(r.device).float()
        if p.shape[0] < r.shape[0]:
            p = torch.cat([p, p.new_zeros((r.shape[0] - p.shape[0],)
                                          + p.shape[1:])])
        full[k] = p
    return head_gap(full, ref)


def input_gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """The largest distance of the network input from the reference's, as
    a share of the reference's largest value."""
    return float((prog.float() - ref).abs().max()
                 / ref.abs().max().clamp(min=1e-30))


# -- training ------------------------------------------------------------------

def _schedule(cfg: Dict, step: int) -> float:
    """The configuration's learning rate at ``step``: cosine decay over
    ``scheduler.T_max`` to ``eta_min``."""
    base = cfg["optimizer"]["lr"]
    sch = cfg.get("scheduler") or {}
    if sch.get("type") != "CosineAnnealingLR":
        raise KeyError(f"no schedule rule for {sch!r}")
    T = max(1, sch["T_max"])
    alpha = sch.get("eta_min", 0.0) / base
    t = min(step, T)
    return base * ((1 - alpha) * 0.5 * (1 + np.cos(np.pi * t / T)) + alpha)


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double()))
            for k, v in tensors.items()}


def train_steps(cfg: Dict, sd, batches: Sequence[Dict[str, torch.Tensor]],
                level: str) -> Dict:
    """The configuration's training steps over ``batches`` at ``level``:
    the train-mode forward (float32 master weights cast as the level and
    the configuration say: a LiDAR configuration computes float32 on
    bf16-rounded weights), the ten-term loss in float32, the backward and
    Adam (b1 0.9, b2 0.999, eps 1e-8) at the scheduled rate.  Returns each
    step's loss, the first step's head outputs (float32), the first step's
    gradient norm by leaf and the norm of the change after the last step by
    leaf."""
    from .plain.models.head_losses import column_proposal_loss, head_hparams

    device = next(iter(sd.values())).device
    model = plain_model(cfg, sd, device).train()
    hp = head_hparams(_cfg(cfg))
    lidar = cfg.get("use_lidar", False)
    round_w = lidar and cfg.get("train_compute_dtype") == "bfloat16"
    params = dict(model.named_parameters())
    start = {k: v.detach().clone() for k, v in params.items()}
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v2 = {k: torch.zeros_like(v) for k, v in params.items()}
    hs = hook_inputs(model, level)
    losses, grad1, out1 = [], None, None
    with strict_float32():
        for i, b in enumerate(batches):
            w = weights_at(model, level)
            if round_w and level == "float32":
                w = {k: p.to(torch.bfloat16).float() for k, p in w.items()}
            if lidar:
                inp = {"points": b["points"], "points_mask": b["points_mask"]}
            else:
                inp = b["proj"].to(activation_dtype(level)).contiguous()
            out = torch.func.functional_call(model, w, (inp,))
            loss = column_proposal_loss(out, b, hp)["loss"]
            grads = torch.autograd.grad(loss, list(params.values()),
                                        allow_unused=True)
            losses.append(float(loss.detach()))
            g = {k: (gr if gr is not None else torch.zeros_like(params[k]))
                 for k, gr in zip(params, grads)}
            if i == 0:
                grad1 = leaf_norms(g)
                out1 = {k: v.detach().float() for k, v in out.items()}
            lr = _schedule(cfg, i)
            t = i + 1
            with torch.no_grad():
                for k, p in params.items():
                    m[k].mul_(0.9).add_(g[k], alpha=0.1)
                    v2[k].mul_(0.999).addcmul_(g[k], g[k], value=0.001)
                    den = (v2[k] / (1 - 0.999 ** t)).sqrt_().add_(1e-8)
                    p.sub_(lr * (m[k] / (1 - 0.9 ** t)) / den)
    for h in hs:
        h.remove()
    change = leaf_norms({k: params[k].detach() - start[k] for k in params})
    del model, m, v2, start
    return {"losses": losses, "out1": out1, "grad1": grad1,
            "change": change}


def norm_gap(prog: Dict[str, float], ref: Dict[str, float],
             keep=None, worst=None, label="", q=None) -> float:
    """The leaves' gaps between the program's norm and the reference's,
    each over the larger of that leaf's reference norm and the median
    leaf's: the worst (``worst[label]`` gets that leaf and its norms), or
    with ``q`` that quantile of the gaps."""
    keys = [k for k in ref if keep is None or k in keep]
    med = float(np.median([ref[k] for k in keys]))
    gaps = {k: abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in keys}
    if q is not None:
        return float(np.quantile(list(gaps.values()), q))
    k = max(gaps, key=gaps.get)
    if worst is not None:
        worst[label] = [k, prog[k], ref[k], med]
    return gaps[k]


def moved_leaves(grad1: Dict[str, float]) -> set:
    """The leaves whose first reference gradient is at least a thousandth
    of the median leaf's: the others (a key's bias under softmax, say) move
    under Adam by round-off alone."""
    med = float(np.median(list(grad1.values())))
    return {k for k, v in grad1.items() if v >= 1e-3 * med}
