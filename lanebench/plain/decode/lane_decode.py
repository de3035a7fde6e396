"""Lane decode on the card: raw head maps -> per-proposal coordinates and
endpoints.  Port of `lanemapping_tpu/decode/lane_decode.py` (reference
`heads/polyline_fpn_vit_vertex_2.py:602-759`).

Every softmax is taken in float32 whatever the network's working dtype.
The +-2-neighbourhood expectation re-softmaxes the already-softmaxed window
probabilities, as the reference does.  Endpoints: sigmoid heatmap, border
crop, top-K peaks, then single-linkage radius clustering to a fixpoint
(DBSCAN(eps, min_samples=1) is exactly the connected components of the
eps-graph).  The JAX package runs the fixpoint in a ``while_loop``; here it
is a Python loop that reads one flag back from the device per iteration.
"""

from __future__ import annotations

from typing import Dict

import torch

LOCAL_WIDTH = 2  # +-2 neighbourhood (reference `:700`)


def window_expectation(cls_probs: torch.Tensor) -> torch.Tensor:
    """Expected column inside the +-2 window around the argmax.

    ``cls_probs``: softmaxed [..., W] class probabilities.  Reference
    semantics (`:717-726`): window j in [max(0, i-2), min(W-1, i+3)),
    re-softmax the probs inside the window, expectation over j."""
    W = cls_probs.shape[-1]
    idx = torch.argmax(cls_probs, dim=-1)
    offs = torch.arange(-LOCAL_WIDTH, LOCAL_WIDTH + 1, device=idx.device)
    j = idx[..., None] + offs  # [..., 5]
    valid = (j >= 0) & (j <= W - 2)  # right bound exclusive at W-1
    jc = torch.clamp(j, 0, W - 1)
    p = torch.gather(cls_probs, -1, jc)
    p = torch.where(valid, p, torch.full_like(p, float("-inf")))
    pw = torch.softmax(p, dim=-1)
    pw = torch.where(valid, pw, torch.zeros_like(pw))
    return torch.sum(pw * jc.to(pw.dtype), dim=-1)


def cluster_peaks(coords: torch.Tensor, radius: float):
    """Single-linkage radius clustering of [B,K,2] points.

    Returns (rep_coords [B,K,2], rep_valid [B,K]): one representative per
    cluster — the member closest to the cluster centroid (reference
    `cluster_select_topK_pts`, `:903-924`) — in the slot of the cluster's
    smallest member index; other slots carry rep_valid=False.  Labels run
    neighbour-min propagation with pointer jumping to a fixpoint."""
    B, K, _ = coords.shape
    pts = coords.float()
    d2 = torch.sum((pts[:, :, None, :] - pts[:, None, :, :]) ** 2, dim=-1)
    adj = d2 <= radius * radius  # includes self
    labels = torch.arange(K, device=pts.device).expand(B, K).contiguous()
    sentinel = torch.full_like(labels, K)[:, None, :].expand(B, K, K)
    while True:
        lab_mat = torch.where(adj, labels[:, None, :], sentinel)
        new = torch.min(lab_mat, dim=2).values
        new = torch.minimum(new, torch.gather(new, 1, new))  # pointer jump
        changed = bool(torch.any(new != labels))  # one device->host read
        labels = new
        if not changed:
            break
    onehot = (labels[:, :, None]
              == torch.arange(K, device=pts.device)).float()  # [B,K,K(lab)]
    sizes = onehot.sum(dim=1)  # [B,K]
    cent = torch.bmm(onehot.transpose(1, 2), pts) \
        / torch.clamp(sizes[..., None], min=1.0)
    dc = torch.sum((pts - torch.gather(
        cent, 1, labels[..., None].expand(B, K, 2))) ** 2, dim=-1)  # [B,K]
    d_mat = torch.where(onehot.transpose(1, 2) > 0, dc[:, None, :],
                        torch.full_like(dc[:, None, :], 1e12))
    rep_idx = torch.argmin(d_mat, dim=2)  # [B,K]
    rep_coords = torch.gather(pts, 1, rep_idx[..., None].expand(B, K, 2))
    return rep_coords, sizes > 0


def decode_endpoints(endp_logits: torch.Tensor, num_cls: int,
                     clip_w: int = 20, radius: float = 20.0,
                     top_k: int = None, score_thre: float = 0.0):
    """Endpoint extraction (reference `:638-688`): sigmoid the [B,H,W]
    heatmap, crop a ``clip_w`` border, take the top-K scores (exact
    ``torch.topk``; the JAX package's default ``approx_max_k`` is a TPU
    partial reduction), cluster within ``radius``, keep one representative
    per cluster.  Candidates scored below ``score_thre`` collapse into one
    far-away sentinel cluster that is then invalidated.

    Returns (coords [B,K,2] float32, valid [B,K])."""
    if top_k is None:
        top_k = num_cls * 2 * 10
    B, H, W = endp_logits.shape
    inner = endp_logits[:, clip_w:H - clip_w, clip_w:W - clip_w]
    iw = inner.shape[2]
    scores = torch.sigmoid(inner.reshape(B, -1))
    top_scores, top_idx = torch.topk(scores, top_k, dim=-1)
    hh = (top_idx // iw + clip_w).float()
    ww = (top_idx % iw + clip_w).float()
    coords = torch.stack([hh, ww], dim=-1)  # [B,K,2]
    coords = torch.where((top_scores >= score_thre)[..., None], coords,
                         torch.full_like(coords, -1e4))
    rep_coords, rep_valid = cluster_peaks(coords, radius)
    return rep_coords, rep_valid & (rep_coords[..., 0] >= 0.0)


# decode keys the host postprocess reads
HOST_DECODE_KEYS = ("prop_conf", "prop_v_ext", "cls_offset", "cls",
                    "cls_exp", "orient", "bi_seg_rows", "endp_coords",
                    "endp_valid", "endp_logits")


def host_decode_view(dec: Dict) -> Dict:
    """Subset of a decode dict consumed by `postprocess.lane_maps_from_decode`."""
    return {k: v for k, v in dec.items() if k in HOST_DECODE_KEYS}


def decode_lanes(out: Dict, cfg) -> Dict:
    """Full decode dict (reference `get_exist_coor_endp_dict`, `:602-759`)
    from the NHWC raw map dict of `models.nets.Detector1stage`."""
    h = cfg.heads
    prop_w = h.prop_width + 2 * h.prop_half_buff
    exist_thre, coor_thre = cfg.exist_thre, cfg.coor_thre
    f32 = torch.float32

    prop_conf = torch.softmax(out["proposal_conf"].to(f32), -1)
    orient_cls = torch.argmax(out["orient"], dim=-1)  # [B,S,S]

    # anchor rows (8r+3) are all the host postprocess reads
    sem_rows = torch.softmax(out["semantic_seg"][:, 3::8, :, :].to(f32), -1)
    bi_seg_rows = sem_rows[..., 1] + sem_rows[..., 2]  # [B,S,8S]
    sem_extra = {}
    if cfg.get("show_result", False) or cfg.get("view_detail", False):
        sem = torch.softmax(out["semantic_seg"].to(f32), -1)
        p1, p2 = sem[..., 1], sem[..., 2]
        sem_extra["semantic_seg"] = torch.where(
            (p1 > p2) & (p1 > coor_thre), 1,
            torch.where((p2 > p1) & (p2 > coor_thre), 2, 0))

    ext = torch.softmax(out["ext2"].to(f32), -1)
    e1, e2 = ext[..., 1], ext[..., 2]
    prop_v_ext = torch.where((e1 > e2) & (e1 > exist_thre), 1.0,
                             torch.where((e2 > e1) & (e2 > exist_thre), 2.0,
                                         0.0))

    cls_probs = torch.softmax(out["cls2"].to(f32), -1)
    cls_max = torch.argmax(cls_probs, dim=-1)  # [B,P,S]
    corr_exp = window_expectation(cls_probs)
    off_at_max = torch.gather(out["offset2"].to(f32), -1,
                              cls_max[..., None])[..., 0]
    corr_offset = cls_max.to(f32) + off_at_max
    corr_idx = cls_max.to(f32)

    base = (h.prop_width * torch.arange(h.num_prop, device=ext.device)
            - h.prop_half_buff).to(f32)[None, :, None]
    corr_idx, corr_exp, corr_offset = (
        torch.clamp(v, max=float(prop_w)) + base
        for v in (corr_idx, corr_exp, corr_offset))

    endp_key = "endpoint" if h.get("endp_mode", "endp_est") == "endpoint" \
        else "endp_est"
    # endpoint path selector (cfg.endp_decode): 'exact_host' ships the raw
    # logits to the host for the reference's adaptive-K loop
    # (decode/endpoints_host.py); any other value decodes fixed-K top-k here
    if cfg.get("endp_decode", "approx_topk") == "exact_host":
        endp_extra = {"endp_logits": out[endp_key][..., 0]}
        K = cfg.number_lanes * 2 * 10
        B = out[endp_key].shape[0]
        endp_coords = torch.zeros((B, K, 2), dtype=f32, device=ext.device)
        endp_valid = torch.zeros((B, K), dtype=torch.bool, device=ext.device)
    else:
        endp_extra = {}
        endp_coords, endp_valid = decode_endpoints(
            out[endp_key][..., 0], num_cls=cfg.number_lanes,
            radius=cfg.get("endp_cluster_r", 20.0),
            top_k=cfg.get("endp_top_k", None),
            score_thre=cfg.get("endp_score_thre", 0.0))

    return {
        **endp_extra,
        **sem_extra,
        "prop_conf": prop_conf,
        "prop_v_ext": prop_v_ext,
        "prop_cls_conf": cls_probs,
        "orient": orient_cls,
        "bi_seg_rows": bi_seg_rows,
        "cls": corr_idx,
        "cls_exp": corr_exp,
        "cls_offset": corr_offset,
        "endp_coords": endp_coords,
        "endp_valid": endp_valid,
    }
