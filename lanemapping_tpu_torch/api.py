"""High-level API (port of `lanemapping_tpu/api.py`).

    import lanemapping_tpu_torch as lmt
    mapper = lmt.LaneMapper("configs/Proj_polyline_fpn_vit_vertex_2.py",
                            ckpt="model.pth")          # runs on the card
    lanes = mapper.map_tiles(["tile1.png", "tile2.png"])

The mapper runs on ``device="cuda"`` unless the caller asks for the CPU; it
raises when CUDA is asked for and there is no card, rather than carrying on
elsewhere.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """``torch.device(device)``, refusing CUDA on a machine with no card."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "lanemapping_tpu_torch runs on a CUDA device by default and none "
            "is available; pass device='cpu' to run on the CPU")
    return device


def load_checkpoint(model: torch.nn.Module, path: str) -> torch.nn.Module:
    """Load a torch checkpoint: a plain ``state_dict`` or a reference
    ``{net|state_dict|model: ...}`` container, ``module.`` prefixes
    stripped.  BatchNorm ``num_batches_tracked`` may be absent."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(ckpt, dict):
        for key in ("net", "state_dict", "model"):
            if isinstance(ckpt.get(key), dict):
                ckpt = ckpt[key]
                break
    sd = {k[len("module."):] if k.startswith("module.") else k: v
          for k, v in ckpt.items()}
    missing, unexpected = model.load_state_dict(sd, strict=False)
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    if missing or unexpected:
        raise KeyError(f"{path}: missing {missing[:8]}, unexpected "
                       f"{unexpected[:8]}")
    return model


def forward_decode(model: torch.nn.Module, tiles: torch.Tensor, cfg) -> Dict:
    """[B,H,W,3] tiles (on the model's device and dtype) -> the decode keys
    the host postprocess reads, still on the device."""
    from .decode.lane_decode import decode_lanes, host_decode_view

    with torch.inference_mode():
        return host_decode_view(decode_lanes(model(tiles), cfg))


def to_numpy(dec: Dict) -> Dict[str, np.ndarray]:
    return {k: v.cpu().numpy() for k, v in dec.items()}


class LaneMapper:
    def __init__(self, config, ckpt: Optional[str] = None,
                 device: Union[str, torch.device] = "cuda"):
        from .config.config import Config
        from .models.nets import build_model

        self.device = resolve_device(device)
        self.cfg = Config.fromfile(config) if isinstance(config, str) \
            else config
        model = build_model(self.cfg, seed=self.cfg.get("seed", 0))
        if ckpt:
            load_checkpoint(model, ckpt)
        self.model = model.to(self.device)

    # -- tiles -> decoded polylines -----------------------------------------
    def map_arrays(self, tiles: np.ndarray) -> List[Dict]:
        """[B,H,W,3] float tiles -> list of per-tile lane dicts:
        {'lanes': [lane records], 'endpoints': [M,2], 'semantic_map'}."""
        from .decode.postprocess import lane_maps_from_decode
        from .tools.export_lanes import lane_records

        x = torch.as_tensor(np.asarray(tiles, np.float32), device=self.device)
        dec = to_numpy(forward_decode(self.model, x, self.cfg))
        maps = lane_maps_from_decode(dec, self.cfg)
        return [{"lanes": lane_records(maps["cls_offset_smooth"][b]),
                 "endpoints": np.argwhere(maps["endp_by_cls"][b] > 0),
                 "semantic_map": maps["semantic_line"][b]}
                for b in range(len(tiles))]

    def map_tiles(self, paths: Sequence[str]) -> List[Dict]:
        from PIL import Image

        tiles = []
        for p in paths:
            img = np.array(Image.open(p))
            if img.ndim == 2:
                img = np.stack([img] * 3, -1)
            tiles.append(img[..., :3].astype(np.float32) / 255.0)
        return self.map_arrays(np.stack(tiles))
