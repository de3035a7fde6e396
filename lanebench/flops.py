"""The benchmark's yardsticks, computed from shapes on its own frozen plain
model (`lanebench/plain`), never on the program's: the model FLOPs of a
served tile and of a training step, and the bytes each binning kernel has
to move.

FLOPs are counted by ``FlopCounterMode`` on the ``meta`` device (nothing
runs): the convolutions and matrix products of the forward (eval mode) at
one tile, or of the train-mode forward, the ten-term loss and the backward
at the cell's batch, without rematerialisation.  Bytes count each input
byte once and each output byte once, as a roofline's floor.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

FLOAT = 4  # bytes of a float32
BOOL = 1


def k1_bytes(batch: int, n_points: int, n_cols: int, img: int) -> int:
    """K1 (BEV rasterize): [B,N,C] float32 points and [B,N] mask in, the
    [B,img,img] float32 mean and count out."""
    return (batch * n_points * (n_cols * FLOAT + BOOL)
            + 2 * batch * img * img * FLOAT)


def k1z_bytes(batch: int, n_points: int, n_cols: int,
              grid: Sequence[int]) -> int:
    """K1z (z-fold voxelize): [B,N,C] float32 points and [B,N] mask in, the
    [B,Y,X,Z*C] float32 voxel means out."""
    X, Y, Z = grid
    return (batch * n_points * (n_cols * FLOAT + BOOL)
            + batch * Y * X * Z * n_cols * FLOAT)


def _meta_inputs(cfg: Dict, batch: int, n_points: int):
    img = cfg["list_img_size_xy"][0]
    if cfg.get("use_lidar", False):
        return {"points": torch.zeros((batch, n_points, 4), device="meta"),
                "points_mask": torch.ones((batch, n_points), dtype=torch.bool,
                                          device="meta")}
    return torch.zeros((batch, img, img, 3), device="meta")


def _meta_labels(cfg: Dict, batch: int) -> Dict[str, torch.Tensor]:
    img = cfg["list_img_size_xy"][0]
    h = cfg["heads"]
    S, P = h["row_size"], h["num_prop"]
    W = h["prop_width"] + 2 * h["prop_half_buff"]
    B = batch
    shapes = {"prop_ext": ((B, P, S), torch.uint8),
              "prop_coor": ((B, P, S), torch.float32),
              "prop_offset": ((B, P, S, W), torch.float32),
              "prop_offset_mask": ((B, P, S, W), torch.float32),
              "lc_orient": ((B, S, S), torch.uint8),
              "semantic_label_raw": ((B, img, img), torch.uint8),
              "endp_map": ((B, img, img), torch.float32),
              "prop_inst": ((B, img, img), torch.uint8),
              "prop_best": ((B, P), torch.uint8)}
    return {k: torch.zeros(s, dtype=d, device="meta")
            for k, (s, d) in shapes.items()}


def model_flops(cfg: Dict, batch: int, train: bool,
                n_points: int = 1 << 19) -> int:
    """FLOPs of one forward at ``batch`` tiles (``train=False``) or of one
    training step (``train=True``)."""
    from torch.utils.flop_counter import FlopCounterMode

    from .plain import ConfigDict, build_model
    from .plain.models.head_losses import column_proposal_loss, head_hparams

    model = build_model(cfg).to("meta").train(train)
    inp = _meta_inputs(cfg, batch, n_points)
    with FlopCounterMode(display=False) as fc:
        if train:
            out = model(inp)
            loss = column_proposal_loss(out, _meta_labels(cfg, batch),
                                        head_hparams(ConfigDict(cfg)))["loss"]
            loss.backward()
        else:
            with torch.no_grad():
                model(inp)
    return int(fc.get_total_flops())
