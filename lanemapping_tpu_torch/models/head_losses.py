"""Training loss of the ColumnProposal2 head (port of
`lanemapping_tpu/models/head_losses.py`, reference
`heads/polyline_fpn_vit_vertex_2.py:446-600`).

Pure functions over the raw head-output dict (the port's
``Detector1stage`` output: NHWC image maps, [B, P, ...] proposal maps) and
the device batch.  Every term keeps the JAX package's reduction and
normalisation, quirks included: the semantic term is divided by the pixel
count ``S*S*64`` and not by batch; ``safe_div`` returns 0 for a batch with
no valid vertex; the endpoint focal weights positives by ``endp_pos_w`` and
negatives by ``endp_neg_w``.  The losses run in float32 whatever the
outputs' dtype.  ``segmentor_loss`` is the Segmentor's pretraining loss.

In a process group of more than one rank (`parallel/dist.py`) each rank's
loss is its contribution to the loss of the global batch, as the JAX loss
under pjit computes it: the local numerator over the global denominator
(the batch size ``B``, the counts ``n_valid`` and ``n_orient``, summed
over the ranks without gradient, and the mean's element count), so the
ranks' contributions sum to the global loss, and ``safe_div`` and the
orientation term test the global count.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch.utils.checkpoint import checkpoint

from ..ops.interp import _interp_matrix_np
from ..parallel.dist import global_mean, global_rows, sum_over_ranks
from ..ops.losses import (cross_entropy_with_int_labels, optax_sigmoid_ce,
                          sigmoid_focal_loss, smooth_l1)

EPS = 1e-12


def _heatmap_f32(x: torch.Tensor) -> torch.Tensor:
    """Endpoint heatmaps may ship as their PNG uint8 (Runner's u8 round
    trip); /255 here is bit-identical to the host float path."""
    if x.dtype == torch.uint8:
        return x.float() / 255.0
    return x.float()


def _seg_focal_rows(uh: torch.Tensor, uw: torch.Tensor,
                    seg_win: torch.Tensor, win: torch.Tensor,
                    best: torch.Tensor, posw: torch.Tensor) -> torch.Tensor:
    """Sum of the positive proposals' focal loss over the full-resolution
    rows that ``uh`` [rows, 2S] selects; ``win`` [B, rows, P, 8W] is the
    instance map's windows on those rows."""
    gt = (win.permute(0, 2, 1, 3) == best[:, :, None, None]).float()
    logits = ((uh @ seg_win) @ uw.T).float()  # [B,P,rows,8W]
    return torch.sum(sigmoid_focal_loss(logits, gt)
                     * posw[:, :, None, None])


def _fused_prop_seg_focal(seg_win: torch.Tensor, inst_m: torch.Tensor,
                          best: torch.Tensor, pos: torch.Tensor,
                          hp) -> torch.Tensor:
    """Per-proposal seg focal term without the [B,P,8S,8W] GT on the host.

    The same value as upsampling ``prop_seg_small`` [B,P,2S,2W] to
    [B,P,8S,8W] and taking the focal loss against the windowed per-lane
    GT (reference `:523-526`), with the GT derived on the device: proposal
    p's window of the 255-padded merged instance map ``prop_inst``
    [B,8S,8S] u8 (a strided ``unfold`` view), compared with its assigned
    lane ``prop_best`` [B,P].  With ``seg_focal_chunks > 1`` the rows run
    chunk by chunk under ``torch.utils.checkpoint``, so the full-resolution
    logits of only one chunk exist at a time."""
    S, P, W = hp["row_size"], hp["num_prop"], hp["prop_fea_width"]
    pw = hp["prop_width"]
    hb = (W - pw) // 2
    ds = 8
    B, H, Wfull = seg_win.shape[0], S * ds, W * ds
    stride = pw * ds
    if not (S == pw * P and Wfull % stride == 0 and H % 8 == 0):
        raise ValueError(f"fused seg focal needs S==pw*P and W%pw==0; got "
                         f"S={S} P={P} pw={pw} W={W}")
    uh = torch.as_tensor(_interp_matrix_np(2 * S, H), dtype=seg_win.dtype,
                         device=seg_win.device)
    uw = torch.as_tensor(_interp_matrix_np(2 * W, Wfull),
                         dtype=seg_win.dtype, device=seg_win.device)
    n_chunk = int(hp.get("seg_focal_chunks", 1) or 1)
    if H % n_chunk:
        raise ValueError(f"seg_focal_chunks={n_chunk} must divide {H} rows")
    rows = H // n_chunk

    inst_pad = torch.nn.functional.pad(inst_m, (hb * ds, hb * ds),
                                       value=255)
    win = inst_pad.unfold(-1, Wfull, stride)[:, :, :P]  # [B,H,P,8W] view
    posw = pos.float()
    bestu = best.to(inst_m.dtype)
    if n_chunk == 1:
        total = _seg_focal_rows(uh, uw, seg_win, win, bestu, posw)
    else:
        total = seg_win.new_zeros((), dtype=torch.float32)
        for k in range(n_chunk):
            r = slice(k * rows, (k + 1) * rows)
            total = total + checkpoint(_seg_focal_rows, uh[r], uw, seg_win,
                                       win[:, r], bestu, posw,
                                       use_reentrant=False)
    return total / (S * S * ds * global_rows(B))


def column_proposal_loss(out: Dict, batch: Dict, hp) -> Dict:
    """10-term loss of the ColumnProposal2 head (reference `:446-600`):
    {'loss': scalar, 'loss_stats': {term: scalar}}."""
    S = hp["row_size"]
    P = hp["num_prop"]
    W = hp["prop_fea_width"]
    B = global_rows(out["ext2"].shape[0])
    f32 = torch.float32

    gt_exist = batch["prop_ext"].to(f32)   # [B,P,S] in {0,1,2}
    gt_coors = batch["prop_coor"].to(f32)  # [B,P,S]
    gt_offset = batch["prop_offset"].to(f32)
    gt_offset_mask = batch["prop_offset_mask"].to(f32)

    # vertex validity mangling (reference `:461-465`)
    invalid = (gt_coors >= W) | (gt_coors < 0.0) | (gt_exist == 0)
    gt_coors = torch.where(invalid, -1.0, gt_coors)
    gt_exist = torch.where(invalid, 0.0, gt_exist)
    valid = gt_exist > 0
    n_valid = sum_over_ranks(torch.sum(valid))

    # proposal objectness targets (reference `:469-472`)
    pos = torch.sum(gt_exist, dim=2) > 2.0  # [B,P]
    posf = pos.to(f32)
    gt_prop = torch.stack([1.0 - posf, posf], dim=-1)
    proposal_loss = global_mean(
        optax_sigmoid_ce(out["proposal_conf"].float(), gt_prop))

    # per-row existence/semantic CE inside positive proposals (`:531`)
    ext_ce = cross_entropy_with_int_labels(out["ext2"], gt_exist.long())
    ext_loss = torch.sum(ext_ce * pos[:, :, None]) * hp["ext_w"] \
        / (P * S * B)

    # column classification + expectation regression (`:535-538`)
    cls2 = out["cls2"].float()
    vmask = valid.to(f32)

    def safe_div(x):
        return torch.where(n_valid > 0, x / n_valid.clamp(min=1), 0.0)

    cls_smooth_loss = torch.zeros((), dtype=f32, device=cls2.device)
    if hp["cls_exp"]:
        col_idx = torch.arange(W, dtype=f32, device=cls2.device)
        corr_pred = torch.sum(col_idx * torch.softmax(cls2, dim=-1), dim=-1)
        cls_mean_loss = safe_div(torch.sum(
            smooth_l1(corr_pred, gt_coors) * vmask)) * hp["mean_loss_w"]
        cls_ce = cross_entropy_with_int_labels(cls2, gt_coors.long())
        cls_loss = safe_div(torch.sum(cls_ce * vmask)) * hp["lambda_cls"]

        if hp.get("cls_smooth", False):
            # orientation-consistency smoothness (reference `:540-555`):
            # successive-row coordinate deltas should match the local
            # orientation expectation, read from each proposal's window
            o_idx = torch.arange(hp["number_orients"], dtype=f32,
                                 device=cls2.device)
            orient_exp = torch.sum(
                o_idx * torch.softmax(out["orient"].float(), -1), dim=-1)
            delta_orient = (orient_exp - 5.0) * 0.5  # [B,S,S]
            pw = hp.get("prop_width", 2)
            pad = (W - pw) // 2  # == prop_half_buff
            delta_pad = torch.nn.functional.pad(delta_orient, (pad, pad))
            # window per proposal: columns [pw*p, pw*p + W) -> [B,P,S,W]
            local = delta_pad.unfold(-1, W, pw)[:, :, :out["cls2"].shape[1]]
            local = local.permute(0, 2, 1, 3)
            rowsel = torch.clamp(corr_pred.long(), 0, W - 1)
            delta_roi = torch.gather(local, -1, rowsel[..., None])[..., 0]
            delta_pred = torch.cat(
                [torch.zeros_like(corr_pred[:, :, :1]),
                 corr_pred[:, :, 1:] - corr_pred[:, :, :-1]], dim=2)
            cls_smooth_loss = safe_div(torch.sum(
                smooth_l1(delta_pred, delta_roi) * vmask)) * \
                hp.get("cls_smooth_loss_w", 0.0)
    else:
        cls_mean_loss = torch.zeros((), dtype=f32, device=cls2.device)
        cls_loss = safe_div(-torch.sum(
            gt_coors * torch.log(cls2 + EPS) * vmask[..., None].squeeze(-1)))

    # sub-bin offset regression (`:562-563`)
    offset_loss = safe_div(torch.sum(smooth_l1(
        out["offset2"].float() * gt_offset_mask,
        gt_offset * gt_offset_mask))) * hp["offset_w"]

    # orientation CE on labelled pixels (`:491-492,570-571`)
    lb_orient = batch["lc_orient"].long()  # [B,S,S]
    omask = lb_orient > 0
    orient_ce = cross_entropy_with_int_labels(out["orient"], lb_orient)
    n_orient = sum_over_ranks(torch.sum(omask))
    orient_loss = torch.where(
        n_orient > 0,
        hp["orient_w"] * torch.sum(orient_ce * omask)
        / n_orient.clamp(min=1), 0.0)

    # global semantic segmentation (`:495,572` — batch-independent norm)
    sem_lb = batch["semantic_label_raw"].long()  # [B,8S,8S]
    sem_ce = cross_entropy_with_int_labels(out["semantic_seg"], sem_lb)
    semantic_loss = torch.sum(sem_ce) / (S * S * 64)

    # global endpoint heatmap focal (`:498-509,573`)
    lb_endp = _heatmap_f32(batch["endp_map"])  # [B,8S,8S]
    has_endp = (torch.sum(lb_endp, dim=(1, 2)) > 1.0).to(f32)
    w_endp = torch.where(lb_endp > EPS, lb_endp * hp.get("endp_pos_w", 4.0),
                         hp.get("endp_neg_w", 0.5))
    tgt_endp = (lb_endp > EPS).to(f32)
    endp_logits = (out["endpoint"] if hp["endp_mode"] == "endpoint"
                   else out["endp_est"])[..., 0].float()
    focal = sigmoid_focal_loss(endp_logits, tgt_endp)
    endp_loss = hp["endp_loss_w"] * torch.sum(
        w_endp * focal * has_endp[:, None, None]) / (S * S * B)

    # per-proposal binary seg focal, positive proposals only (`:523-526,574`)
    if hp["spatial_att"]:
        if (hp.get("fused_seg_focal", True) and "prop_inst" in batch
                and "prop_seg_small" in out):
            bi_seg_loss = _fused_prop_seg_focal(
                out["prop_seg_small"], batch["prop_inst"],
                batch["prop_best"], pos, hp)
        else:
            seg_focal = sigmoid_focal_loss(out["prop_bi_seg"].float(),
                                           batch["prop_bi_seg"].float())
            bi_seg_loss = torch.sum(
                seg_focal * pos[:, :, None, None]) / (S * S * 8 * B)
    else:
        bi_seg_loss = torch.zeros((), dtype=f32, device=cls2.device)

    loss = (proposal_loss + ext_loss + cls_mean_loss + cls_loss +
            cls_smooth_loss + endp_loss + orient_loss + bi_seg_loss +
            offset_loss + semantic_loss)
    return {
        "loss": loss,
        "loss_stats": {
            "proposal_loss": proposal_loss,
            "ext_loss2": ext_loss,
            "cls_loss2": cls_loss,
            "cls_mean_loss2": cls_mean_loss,
            "cls_smooth_loss2": cls_smooth_loss,
            "endp_loss": endp_loss,
            "orient_loss": orient_loss,
            "binary_seg_loss": bi_seg_loss,
            "offset_loss": offset_loss,
            "semantic_seg_loss": semantic_loss,
        },
    }


def segmentor_loss(out: Dict, batch: Dict) -> Dict:
    """Segmentor pretraining loss (reference `postprojector.py:84-109`):
    the semantic CE over every pixel, and a focal endpoint term weighted
    10x the heatmap on its positives and 0.1 elsewhere, counted only for
    tiles with more than one unit of heatmap."""
    EPS6 = 1e-6
    seg_logits = out["semantic_seg"].float()  # [B,H,W,3]
    b, f_h, f_w, _ = seg_logits.shape
    seg_ce = cross_entropy_with_int_labels(seg_logits, batch["mask"])
    seg_loss = torch.sum(seg_ce) / (global_rows(b) * f_h * f_w)

    lb_endp = _heatmap_f32(batch["endp_map"])
    has_endp = (torch.sum(lb_endp, dim=(1, 2)) > 1.0).float()
    w_endp = torch.where(lb_endp > EPS6, lb_endp * 10.0, 0.1)
    tgt = (lb_endp > EPS6).float()
    focal = sigmoid_focal_loss(out["endp_est"][..., 0].float(), tgt)
    endp_loss = 50.0 * torch.sum(w_endp * focal * has_endp[:, None, None]) \
        / (f_h * f_w)
    return {"loss": seg_loss + endp_loss,
            "loss_stats": {"seg_loss": seg_loss, "endp_loss": endp_loss}}


def head_hparams(cfg) -> Dict:
    """The static loss scalars of a config."""
    h = cfg.heads
    return dict(
        row_size=h.row_size,
        num_prop=h.num_prop,
        prop_fea_width=h.prop_width + 2 * h.prop_half_buff,
        ext_w=h.get("ext_w", 1.0),
        lambda_cls=h.get("lambda_cls", 1.0),
        mean_loss_w=h.get("mean_loss_w", 0.0),
        orient_w=h.get("orient_w", 1.0),
        endp_loss_w=h.get("endp_loss_w", 1.0),
        endp_pos_w=h.get("endp_pos_w", 4.0),
        endp_neg_w=h.get("endp_neg_w", 0.5),
        offset_w=h.get("offset_w", 1.0),
        cls_exp=h.get("cls_exp", True),
        endp_mode=h.get("endp_mode", "endp_est"),
        spatial_att=cfg.get("spatial_att", True),
        cls_smooth=cfg.get("cls_smooth", False),
        cls_smooth_loss_w=h.get("cls_smooth_loss_w", 0.0),
        prop_width=h.prop_width,
        number_orients=cfg.get("number_orients", 11),
        fused_seg_focal=cfg.get("fused_seg_focal", True),
        seg_focal_chunks=cfg.get("seg_focal_chunks", 1),
    )
