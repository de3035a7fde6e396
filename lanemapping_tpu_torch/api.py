"""High-level API (port of `lanemapping_tpu/api.py`).

    import lanemapping_tpu_torch as lmt
    mapper = lmt.LaneMapper("configs/Proj_polyline_fpn_vit_vertex_2.py",
                            ckpt="model.pth")          # runs on the card
    lanes = mapper.map_tiles(["tile1.png", "tile2.png"])
    mapper.map_directory("data/TestArea1", out_dir="out",   # lane JSONs
                         params_dir="data/TestArea1/cropped_tiff_param")
    metrics = mapper.evaluate("data/TestArea1", split="test")

The mapper runs on ``device="cuda"`` unless the caller asks for the CPU; it
raises when CUDA is asked for and there is no card, rather than carrying on
elsewhere.  It holds a ``Runner`` (`engine/runner.py`), whose model it
serves; ``ckpt`` is a torch ``state_dict`` / reference ``.pth`` file or a
Runner checkpoint directory (``<log_dir>/ckpt/<tag>``), of which it reads
the weights alone, so a checkpoint trained on the card serves on the CPU.
"""

from __future__ import annotations

import os
import tempfile
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
    """Load the weights of a torch checkpoint, whatever device it was saved
    on: a plain ``state_dict``, a reference ``{net|state_dict|model: ...}``
    container, or a Runner checkpoint (its directory or ``state.pt``; the
    optimizer, scheduler and generator are not read), ``module.`` prefixes
    stripped.  BatchNorm ``num_batches_tracked`` may be absent.  A 7x7
    stem loads into an ``s2d_stem`` model through the exact kernel
    transform (`models/resnet_fpn.py::load_s2d_stem`)."""
    from .engine.checkpoint import STATE_FILE
    from .models.resnet_fpn import load_s2d_stem

    if os.path.isdir(path):
        path = os.path.join(path, STATE_FILE)
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(ckpt, dict):
        for key in ("net", "state_dict", "model"):
            if isinstance(ckpt.get(key), dict):
                ckpt = ckpt[key]
                break
    sd = {k[len("module."):] if k.startswith("module.") else k: v
          for k, v in ckpt.items()}
    sd = load_s2d_stem(sd, model.state_dict())
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
                 device: Union[str, torch.device] = "cuda",
                 log_dir: Optional[str] = None):
        from .config.config import Config
        from .engine.runner import Runner

        self.device = resolve_device(device)
        self.cfg = Config.fromfile(config) if isinstance(config, str) \
            else config
        self.runner = Runner(self.cfg, device=self.device, log_dir=log_dir
                             or os.path.join(tempfile.gettempdir(),
                                             "lanemapper"))
        if ckpt:
            load_checkpoint(self.runner.model, ckpt)
        self.model = self.runner.model.eval()

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

    # -- full directory pipeline --------------------------------------------
    def map_directory(self, data_root: str, out_dir: str,
                      split: str = "all", params_dir: Optional[str] = None,
                      max_batches: Optional[int] = None) -> str:
        """Dataset dir -> one lane JSON per tile under
        ``<out_dir>/lanes_2d``, which it returns.  With a transform-params
        dir (``cropped_tiff_param``) the lanes are lifted to the LiDAR frame
        (`tools/img2pc.py`, beside ``lanes_2d``) and merged into one global
        map (`tools/merge_lines.py`), as the JAX package's ``api.py:88-96``
        does."""
        from .data.loader import build_dataloader

        ds_cfg = dict(self.cfg.dataset.test)
        ds_cfg["data_root"] = data_root
        ds_cfg["mode"] = split
        loader = build_dataloader(ds_cfg, self.cfg, is_train=False)
        lanes_dir = os.path.join(out_dir, "lanes_2d")
        self.runner.infer_and_export(loader, lanes_dir,
                                     max_batches=max_batches)
        if params_dir and os.path.isdir(params_dir):
            from .tools.img2pc import convert_directory
            from .tools.merge_lines import merge_directory
            pc_dir = convert_directory(
                lanes_dir, os.path.join(data_root, "cropped_tiff"),
                params_dir, n_workers=8)
            merge_directory(pc_dir)
        return lanes_dir

    def evaluate(self, data_root: str, split: str = "test",
                 max_batches: Optional[int] = None) -> Dict:
        """The Runner's validation metrics on a labelled split."""
        from .data.loader import build_dataloader

        ds_cfg = dict(self.cfg.dataset[split if split in self.cfg.dataset
                                       else "test"])
        ds_cfg["data_root"] = data_root
        loader = build_dataloader(ds_cfg, self.cfg, is_train=False)
        return self.runner.validate(loader=loader, max_batches=max_batches)
