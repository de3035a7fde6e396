"""WHU-Lane BEV tile datasets (a copy of `lanemapping_tpu/data/laserlane.py`).

Parity with the reference's `baseline/datasets/laserlane.py:31-246` (basic
seg dataset) and `laserlane_proposals.py:36-264` (column-proposal dataset).
Pure NumPy pipeline — samples are dicts of numpy arrays in NHWC, batched by
`loader.py` and shipped to device by the engine.
"""

from __future__ import annotations

import json
import os.path as osp
import random
from typing import Dict, List

import numpy as np

from ..registry import DATASETS
from .proposal_gt import build_proposal_gt

LABEL_SUBDIRS = ("seq", "semantic", "instance", "orient", "endp")


def load_split(data_root: str, data_split_file: str, mode: str) -> List[str]:
    """Tile stems for a split (reference `laserlane_proposals.py:498-518`)."""
    with open(osp.join(data_root, data_split_file)) as f:
        split = json.load(f)
    if mode == "single":
        return list(split["single"])
    if mode in ("valid", "val"):
        return list(split["valid"])[:150]
    if mode == "test":
        stems = list(split["test"])
        random.shuffle(stems)
        return stems
    if mode in ("all", "infer_only"):
        return list(split["pretrain"])
    return list(split["train"])


def _png(path: str) -> np.ndarray:
    from PIL import Image
    return np.array(Image.open(path))


def load_tile_paths(data_root: str, stem: str,
                    label_subdir: str = "labels") -> Dict[str, str]:
    lbl = osp.join(data_root, label_subdir)
    return {
        "image": osp.join(data_root, "cropped_tiff", stem + ".png"),
        "seq": osp.join(lbl, "sparse_seq", stem + ".json"),
        "semantic": osp.join(lbl, "sparse_semantic", stem + ".png"),
        "instance": osp.join(lbl, "sparse_instance", stem + ".png"),
        "orient": osp.join(lbl, "sparse_orient", stem + ".png"),
        "endp": osp.join(lbl, "sparse_endp", stem + ".png"),
    }


def load_seq_json(path: str, n_lanes: int):
    """Padded endpoint/semantic arrays from the sparse-seq sidecar
    (reference `laserlane_proposals.py:107,130-140`)."""
    with open(path) as f:
        recs = json.load(f)
    initp = np.zeros((n_lanes, 2), np.float64)
    endp = np.zeros((n_lanes, 2), np.float64)
    semantic = np.zeros((n_lanes,), np.float64)
    for i, rec in enumerate(recs[:n_lanes]):
        initp[i] = rec["init_vertex"]
        endp[i] = rec["end_vertex"]
        semantic[i] = rec["semantic"]
    return initp, endp, semantic


def color_jitter(img: np.ndarray, rng: np.random.RandomState,
                 brightness: float = 0.5, contrast: float = 0.5,
                 saturation: float = 0.5) -> np.ndarray:
    """Training-time colour augmentation + 0.5/0.5 normalisation
    (reference `laserlane_proposals.py:255-264`): torchvision ColorJitter
    semantics — multiplicative factors drawn from [1-x, 1+x]."""
    b = rng.uniform(max(0.0, 1 - brightness), 1 + brightness)
    c = rng.uniform(max(0.0, 1 - contrast), 1 + contrast)
    s = rng.uniform(max(0.0, 1 - saturation), 1 + saturation)
    out = img * b
    mean = out.mean(axis=(0, 1), keepdims=True).mean()
    out = (out - mean) * c + mean
    gray = out.mean(axis=-1, keepdims=True)
    out = (out - gray) * s + gray
    out = np.clip(out, 0.0, 1.0)
    return (out - 0.5) / 0.5


def _remap_semantic(mask: np.ndarray) -> np.ndarray:
    """PNG values 128->1 (solid), 255->2 (dashed); reference `:592-594`."""
    out = mask.copy()
    out[mask == 128] = 1
    out[mask == 255] = 2
    return out


@DATASETS.register_module(name="LaserLane")
class LaserLane:
    """Segmentation-pretrain dataset (reference `laserlane.py`)."""

    def __init__(self, data_root: str, data_split_file: str =
                 "data_split-shuffle.json", mode: str = "train", cfg=None):
        self.cfg = cfg
        self.data_root = data_root
        self.mode = mode
        self.stems = load_split(data_root, data_split_file, mode)

    def __len__(self):
        return len(self.stems)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        stem = self.stems[idx]
        p = load_tile_paths(self.data_root, stem,
                            getattr(self, 'label_subdir', 'labels'))
        img = _png(p["image"])
        if img.ndim == 2:
            img = np.stack([img] * 3, -1)
        img = img[..., :3].astype(np.float32) / 255.0
        mask = _remap_semantic(_png(p["semantic"]))
        inst = _png(p["instance"])
        mask = np.where(inst == 0, 0, mask)
        endp = _png(p["endp"]).astype(np.float32) / 255.0
        n_lanes = self.cfg.number_lanes if self.cfg else 12
        ds = self.cfg.get("gt_downsample_ratio", 8) if self.cfg else 8
        # 8x max-pool downsampled instance map with the reference remap
        # (`laserlane.py:91-97,234`): ids>n -> bg, bg 0 -> 255, ids shift -1
        h, w = inst.shape
        inst_ds = inst[:h - h % ds, :w - w % ds].reshape(
            h // ds, ds, w // ds, ds).max(axis=(1, 3)).astype(np.int64)
        inst_ds = np.where(inst_ds > n_lanes, 0, inst_ds)
        label = np.where(inst_ds == 0, 255, inst_ds - 1)
        return {
            "image_name": stem[:11],
            "proj": img,  # [H,W,3] NHWC
            "mask": mask.astype(np.uint8),
            "endp_map": endp,
            "label": label.astype(np.int32),
        }


@DATASETS.register_module(name="LaserLaneProposal")
class LaserLaneProposal:
    """Column-proposal dataset (reference `laserlane_proposals.py:36-264`)."""

    def __init__(self, data_root: str, data_split_file: str =
                 "data_split-shuffle.json", mode: str = "train", cfg=None):
        assert cfg is not None, "LaserLaneProposal needs the global cfg"
        self.cfg = cfg
        self.data_root = data_root
        self.mode = mode
        self.stems = load_split(data_root, data_split_file, mode)

    def __len__(self):
        return len(self.stems)

    # compact dtypes for the on-disk sample cache (lossless: the float
    # sources are themselves uint8 PNGs / small-int ids)
    _CACHE_U8 = {"proj": 255.0, "endp_map": 255.0, "label_raw": 1.0}

    def _cache_path(self, stem: str) -> str:
        # Departure from JAX `laserlane.py:163-170`, which keys the cache by
        # head geometry only: a training sample lacks the evaluation keys
        # (`mask`, `initp`, `endp`), so a cache filled in training would
        # serve evaluation samples without them and the semantic F1 would
        # drop silently.  Training and evaluation samples live apart.
        cfg = self.cfg
        use = "train" if self.mode == "train" else "eval"
        sig = f"{cfg.number_lanes}_{cfg.heads.row_size}_" \
              f"{cfg.heads.num_prop}_{cfg.heads.prop_width}_" \
              f"{cfg.heads.prop_half_buff}_{int(bool(cfg.get('fused_seg_focal', True)))}_{use}"
        d = osp.join(self.data_root, ".gt_cache", sig)
        import os
        os.makedirs(d, exist_ok=True)
        return osp.join(d, stem + ".npz")

    def _cache_load(self, path: str) -> Dict[str, np.ndarray]:
        z = np.load(path, allow_pickle=False)
        out = {}
        for k in z.files:
            v = z[k]
            if k in self._CACHE_U8 and self._CACHE_U8[k] != 1.0:
                v = v.astype(np.float32) / self._CACHE_U8[k]
            elif k == "label_raw":
                v = v.astype(np.int32)
            out[k] = v
        return out

    def _cache_store(self, path: str, sample: Dict) -> None:
        comp = {}
        for k, v in sample.items():
            if isinstance(v, str):
                continue
            if k in self._CACHE_U8:
                comp[k] = np.round(np.asarray(v, np.float64)
                                   * self._CACHE_U8[k]).astype(np.uint8)
            else:
                comp[k] = v
        tmp = path + ".tmp.npz"  # .npz suffix stops savez renaming it
        np.savez(tmp, **comp)
        import os
        os.replace(tmp, path)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        stem = self.stems[idx]
        p = load_tile_paths(self.data_root, stem,
                            getattr(self, 'label_subdir', 'labels'))

        # on-disk sample cache (cfg.gt_cache): the proposal-GT build costs
        # ~0.3 s/tile on one host core (the reference pays it in 12 worker
        # processes every epoch, SURVEY §3.1); float sources are u8 PNGs so
        # the cache roundtrip is exact.  Augmentation needs the raw image,
        # so the cache is bypassed when colour augmentation is on.
        use_cache = bool(cfg.get("gt_cache", False)) and not (
            cfg.get("dataset_color_augment", False) and self.mode == "train")
        cpath = self._cache_path(stem) if use_cache else None
        if cpath and osp.exists(cpath):
            sample = self._cache_load(cpath)
            sample["image_name"] = stem[:11]
            return sample

        img = _png(p["image"])
        if img.ndim == 2:
            img = np.stack([img] * 3, -1)
        img = img[..., :3].astype(np.float32) / 255.0
        if self.mode == "infer_only":
            # streaming-inference fast path: no labels on disk required and
            # no proposal-GT build (the reference always builds GT in the
            # worker, even at test time, `laserlane_proposals.py:102-252`)
            return {"image_name": stem[:11], "proj": img}
        if cfg.get("dataset_color_augment", False) and self.mode == "train":
            img = color_jitter(img, np.random.RandomState(
                np.random.randint(1 << 31)))

        mask = _remap_semantic(_png(p["semantic"]))
        inst_raw = _png(p["instance"]).astype(np.int64)
        ori = _png(p["orient"]).astype(np.int64)
        endp_map = _png(p["endp"]).astype(np.float32) / 255.0
        initp, endp, semantic = load_seq_json(p["seq"], cfg.number_lanes)

        # label refinement (reference `:114-120`): drop ids > n_lanes, zero
        # orient/semantic off-lane, then background 0 -> 255, ids shift -1
        inst_raw = np.where(inst_raw > cfg.number_lanes, 0, inst_raw)
        ori = np.where(inst_raw == 0, 0, ori)
        mask = np.where(inst_raw == 0, 0, mask)
        inst = np.where(inst_raw == 0, 255, inst_raw - 1)

        sample = {"image_name": stem[:11], "proj": img,
                  "label_raw": inst.astype(np.int32)}
        sample.update(build_proposal_gt(
            inst, mask, ori, endp_map, initp, endp, semantic,
            n_cls=cfg.number_lanes, row_size=cfg.heads.row_size,
            ds=cfg.gt_downsample_ratio, num_prop=cfg.heads.num_prop,
            prop_width=cfg.heads.prop_width,
            half_buff=cfg.heads.prop_half_buff,
            # fused seg-focal derives the windowed bi-seg GT on device
            emit_full_bi_seg=not cfg.get("fused_seg_focal", True)))
        if self.mode != "train":
            sample["initp"] = initp.astype(np.float32)
            sample["endp"] = endp.astype(np.float32)
            sample["mask"] = mask.astype(np.uint8)
        if cpath:
            self._cache_store(cpath, sample)
        return sample


@DATASETS.register_module(name="LaserLaneProposalEgo")
class LaserLaneProposalEgo(LaserLaneProposal):
    """Raw-point variant: per-tile .las/.npy clouds + the same proposal GT
    (reference `laserlane_proposals_ego.py`, whose labels live under
    ``labels_inside_lidar_range``).  Points come back as a padded static
    [max_points, 4] buffer + mask instead of ragged mmdet3d structures.
    """

    LABEL_DIR = "labels_inside_lidar_range"

    def __init__(self, data_root, data_split_file="data_split-shuffle.json",
                 mode="train", max_points=None, cfg=None):
        super().__init__(data_root, data_split_file, mode, cfg)
        if max_points is None:
            max_points = cfg.get("max_points", 1 << 19) if cfg else 1 << 19
        self.max_points = int(max_points)
        lbl = osp.join(data_root, self.LABEL_DIR)
        self.label_subdir = self.LABEL_DIR if osp.isdir(lbl) else "labels"
        las_dir = osp.join(data_root, "las")
        self.point_dir = las_dir if osp.isdir(las_dir) else osp.join(
            data_root, "points")

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        from .las import load_lidar_points, pad_points

        sample = super().__getitem__(idx)
        stem = self.stems[idx]
        for ext in (".las", ".npy"):
            p = osp.join(self.point_dir, stem + ext)
            if osp.isfile(p):
                pts, mask = pad_points(load_lidar_points(p), self.max_points)
                sample["points"] = pts
                sample["points_mask"] = mask
                break
        else:
            raise FileNotFoundError(
                f"no point file for {stem} under {self.point_dir}")
        return sample
