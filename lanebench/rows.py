"""What the KLane RowRef cell (`loops/train_rows.py`) needs beside the
shared harness: its seeded weights, its training batches with LaserLane
row labels, and the frozen FLOP count of its step, all on the plain
reference (`lanebench/plain/models/row_head.py`), never on the program.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from .inputs import generator
from .weights import draw_state_dict as draw_shared

LANE_LEAVES = ("w1", "b1", "w2", "b2")
BACKGROUND = 255


def plain_model(cfg: Dict) -> torch.nn.Module:
    from .plain.models.row_head import build_klane
    return build_klane(cfg)


def draw_state_dict(cfg: Dict, seed: int, device: torch.device
                    ) -> Dict[str, torch.Tensor]:
    """The seeded state dict of the configuration's KLane net, float32 on
    ``device``, loadable into the program's net and the plain one alike.

    The lane-batched leaves of each ``PerLaneConvHead`` take the program's
    rule (`models/row_head.py::PerLaneConvHead.reset_parameters`): uniform
    with bound 1/sqrt(fan_in), fan_in the input width of each lane's layer
    (``w1``, ``b1``: the row width; ``w2``, ``b2``: the hidden width),
    from a stream of their own.  Every other leaf, ``lane_emb`` (unit
    normal) included, takes `lanebench/weights.py`'s rule, drawn on a copy
    of the net without the lane-batched leaves."""
    from .plain.models.row_head import PerLaneConvHead

    with torch.device("meta"):
        rest = plain_model(cfg)
    order = list(rest.state_dict())
    lane = []  # (name, shape, bound)
    for mname, m in rest.named_modules():
        if isinstance(m, PerLaneConvHead):
            fan_in = {"w1": m.w1.shape[1], "b1": m.w1.shape[1],
                      "w2": m.w2.shape[1], "b2": m.w2.shape[1]}
            for leaf in LANE_LEAVES:
                lane.append((f"{mname}.{leaf}", getattr(m, leaf).shape,
                             fan_in[leaf] ** -0.5))
                del m._parameters[leaf]
    sd = draw_shared(rest, seed, device)
    g = generator(device, seed, 7)
    flat = torch.rand(sum(s.numel() for _, s, _ in lane), generator=g,
                      device=device)
    for (name, shape, bound), part in zip(
            lane, flat.split([s.numel() for _, s, _ in lane])):
        sd[name] = (part.view(shape) * 2.0 - 1.0) * bound
    return {k: sd[k] for k in order}


def row_labels(n_tiles: int, S: int, n_lanes: int, g: torch.Generator,
               device: torch.device) -> torch.Tensor:
    """[n_tiles, S, S] int32 LaserLane row labels (lane ids 0 to
    ``n_lanes`` - 1, ``BACKGROUND`` elsewhere), as the loader gives them:
    4 to ``n_lanes`` near-vertical lanes a tile, each rasterised on a
    contiguous run of rows (started in the upper half, at least a quarter
    of the tile long), its column drifting up to S/8 over the tile; a
    quarter of a lane's rows hold a second pixel beside the first, and a
    later lane overwrites an earlier one where they cross, so rows hold a
    lane once, twice or not at all."""
    T, L = n_tiles, n_lanes

    def rand(*shape):
        return torch.rand(shape, generator=g, device=device)

    k = torch.randint(4, L + 1, (T,), generator=g, device=device)
    ids = torch.argsort(rand(T, L), 1)  # each tile's lane ids, in order
    active = torch.arange(L, device=device)[None] < k[:, None]  # [T, L]
    r0 = torch.floor(rand(T, L) * (S // 2))
    length = S // 4 + torch.floor(rand(T, L) * (S - r0 - S // 4 + 1))
    c0 = 0.1 * S + 0.8 * S * rand(T, L)
    drift = (rand(T, L) * 2.0 - 1.0) * S / 8
    rows = torch.arange(S, device=device, dtype=torch.float32)
    on = active[..., None] & (rows >= r0[..., None]) \
        & (rows < (r0 + length)[..., None])  # [T, L, S]
    col = torch.round(c0[..., None] + drift[..., None] * (
        rows - r0[..., None]) / S).clamp(0, S - 1).long()  # [T, L, S]
    second = rand(T, L, S) < 0.25
    cols = torch.arange(S, device=device)
    label = torch.full((T, S, S), BACKGROUND, dtype=torch.int32,
                       device=device)
    for j in range(L):  # lane by lane: a later lane overwrites
        c = col[:, j, :, None]
        hit = (cols == c) | (second[:, j, :, None] & (cols == c + 1))
        label = torch.where(on[:, j, :, None] & hit,
                            ids[:, j, None, None].to(torch.int32), label)
    return label


def train_batches(cfg: Dict, n_batches: int, batch: int, seed: int,
                  device: torch.device) -> List[Dict[str, torch.Tensor]]:
    """``n_batches`` distinct batches of ``batch`` tiles on the device: the
    flagship cell's uniform tiles (bf16 under bf16 training) and
    ``row_labels``."""
    img = cfg["list_img_size_xy"][0]
    S = cfg["heads"]["row_size"]
    dtype = torch.bfloat16 if cfg.get("train_compute_dtype") == "bfloat16" \
        else torch.float32
    g = generator(device, seed, 5)
    label = row_labels(n_batches * batch, S, cfg["number_lanes"], g, device)
    return [{"proj": torch.rand((batch, img, img, 3), generator=g,
                                device=device).to(dtype),
             "label": label[i * batch:(i + 1) * batch].contiguous()}
            for i in range(n_batches)]


def loss(out: Dict, batch: Dict, cfg: Dict) -> Dict:
    """``row_shar_loss`` at the configuration's lanes, rows and weight."""
    from .plain.models.row_head import row_shar_loss
    h = cfg["heads"]
    return row_shar_loss(out, batch, n_lanes=cfg["number_lanes"],
                         row_size=h["row_size"],
                         lambda_cls=h.get("lambda_cls", 1.0))


def model_flops(cfg: Dict, batch: int) -> int:
    """FLOPs of one training step at ``batch`` tiles: the train-mode
    forward, ``row_shar_loss`` and the backward, counted by
    ``FlopCounterMode`` on the ``meta`` device (nothing runs)."""
    from torch.utils.flop_counter import FlopCounterMode

    img = cfg["list_img_size_xy"][0]
    S = cfg["heads"]["row_size"]
    with torch.device("meta"):
        model = plain_model(cfg).train()
    labels = {"label": torch.zeros((batch, S, S), dtype=torch.int32,
                                   device="meta")}
    with FlopCounterMode(display=False) as fc:
        out = model(torch.zeros((batch, img, img, 3), device="meta"))
        loss(out, labels, cfg)["loss"].backward()
    return int(fc.get_total_flops())
