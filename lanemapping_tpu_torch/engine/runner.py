"""Training, validation and inference for the Runner (port of
`lanemapping_tpu/engine/runner.py`; reference `engine/runner.py:67-868`).

Seeds, model build, optimizer with its per-iteration schedule,
NaN-guarded updates (`engine/state.py`), periodic validation with the
composite best-model metric ``0.9*coor_F1 + 0.1*endp_F1`` (reference
`runner.py:344`), JSONL logging (``<log_dir>/<tag>.jsonl``) and
checkpoints (`engine/checkpoint.py`), on one device: ``cuda`` unless the
caller asks for the CPU.

In a process group of more than one rank (`parallel/dist.py`; started by
`tools/train.py` with one rank per card of the mesh) each rank's Runner
holds the same seeded model on its own device and follows the JAX
Runner's multi-process branches: the loaders take the rank's rows of each
global batch (`data/loader.py`), the train step works on the global batch
(`engine/state.py`), the logs and TensorBoard are written by rank 0 only,
the mono squeeze is off unless ``cfg.dataset_mono_bev`` pins it (a
per-batch content check could disagree between ranks), every validation
loop scores its rank's rows and merges the metrics over the ranks
(``_merge_metrics``: the mean of the per-rank means, the sum of the
counts), so ``best_metric`` agrees on every rank, checkpoints are written
by rank 0 (`engine/checkpoint.py`), and each rank writes its own tiles'
lane JSONs.

Batches go up as the JAX package ships them (``_device_batch``): small
integer labels in their narrowest dtype, the PNG-sourced ``proj`` and
``endp_map`` re-quantised to their uint8 (exact; /255 on the device), a
mono tile as one channel, bf16 ``endp_map`` under bf16 training where the
u8 round trip does not apply (the LiDAR path), the LiDAR points as they
are.  On a card the host tensors are pinned and copied ``non_blocking``.

It trains, validates and exports every net and head of the shipped
configs: Detector1stage with ColumnProposal2 (lane validation and lane
JSONs), with RowSharNotReducRef or GridSeg (grid validation and the KLane
export driver; also under the legacy Detector), and the Segmentor
(segmentation validation and its metrics driver), and RowSharNotReducRef_Base
as the JAX Runner takes it: ColumnProposal2's loss and lane validation.  Any
other combination is refused.  Every logged record also goes to
TensorBoard scalars, skipped when ``torch.utils.tensorboard`` does not
import, as in the JAX Runner.
"""

from __future__ import annotations

import json
import os
import random
from typing import Dict, Optional, Union

import numpy as np
import torch

from ..api import resolve_device
from ..data.loader import build_dataloader
from ..models.head_losses import (column_proposal_loss, head_hparams,
                                  segmentor_loss)
from ..models.nets import build_model
from ..parallel.dist import all_gather_host, get_world_size, is_main_process
from .checkpoint import load_model, load_network_filtered, save_model
from .pipeline import pipelined
from .state import (create_train_state, eval_step, is_mono_batch,
                    make_train_step)

TRAIN_BATCH_KEYS = ("proj", "prop_ext", "prop_coor", "prop_offset",
                    "prop_offset_mask", "prop_bi_seg", "prop_inst",
                    "prop_best", "lc_orient",
                    "semantic_label_raw", "endp_map", "mask", "label",
                    "points", "points_mask")
KLANE_HEADS = ("RowSharNotReducRef", "GridSeg")
# (net, head) pairs the Runner trains and validates; the Segmentor has no
# head
PORTED = {("Detector1stage", "ColumnProposal2"),
          ("Detector1stage", "RowSharNotReducRef_Base"),
          ("Detector1stage", "RowSharNotReducRef"),
          ("Detector1stage", "GridSeg"), ("Detector", "RowSharNotReducRef"),
          ("Detector", "GridSeg"), ("Segmentor", None)}


class Runner:
    # label arrays with small integer ranges ship in the narrowest dtype
    # (the losses upcast on the device)
    _INT_SHIP = {"prop_bi_seg": np.uint8, "prop_inst": np.uint8,
                 "prop_best": np.uint8, "semantic_label_raw": np.uint8,
                 "mask": np.uint8, "lc_orient": np.uint8,
                 "prop_ext": np.uint8, "prop_offset_mask": np.uint8,
                 "label": np.int16}
    _BF16_SHIP = ("proj", "endp_map")  # only under bf16 training
    # PNG-sourced arrays re-quantise to their uint8 exactly when no float
    # augmentation ran
    _U8_ROUNDTRIP = ("proj", "endp_map")

    def __init__(self, cfg, log_dir: Optional[str] = None,
                 device: Union[str, torch.device] = "cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        seed = cfg.get("seed", 0)
        random.seed(seed)
        np.random.seed(seed)
        torch.manual_seed(seed)

        self.log_dir = log_dir or cfg.get("log_dir", "./logs")
        os.makedirs(self.log_dir, exist_ok=True)
        self.use_lidar = bool(cfg.get("use_lidar", False))

        self.head_type = head_type = cfg.heads.type \
            if "heads" in cfg and cfg.net.type != "Segmentor" else None
        if (cfg.net.type, head_type) not in PORTED:
            raise NotImplementedError(
                f"training {cfg.net.type}/{head_type} is not ported to "
                f"lanemapping_tpu_torch yet")
        model = build_model(cfg, seed=seed).to(self.device)
        if self.device.type == "cuda":
            model = model.to(memory_format=torch.channels_last)
        self.model = model
        self.state = create_train_state(model, cfg)
        self._loss_fn = self._build_loss(cfg, head_type)
        self.compute_dtype = torch.bfloat16 \
            if cfg.get("train_compute_dtype") == "bfloat16" else None
        self.train_step = make_train_step(self._loss_fn, self.compute_dtype,
                                          self.use_lidar)
        self.best_metric = -1.0

        if cfg.get("load_from"):
            load_model(cfg.load_from, self.state, seed)
        elif cfg.get("finetune_from"):
            load_network_filtered(cfg.finetune_from, self.state)

    @staticmethod
    def _build_loss(cfg, head_type):
        """The loss of the net and head (the JAX Runner's dispatch,
        `runner.py:70-90` there)."""
        if cfg.net.type == "Segmentor":
            return segmentor_loss
        if head_type == "RowSharNotReducRef":
            from ..models.row_head import row_shar_loss
            n_lanes, row_size = cfg.number_lanes, cfg.heads.row_size
            lam = cfg.heads.get("lambda_cls", 1.0)
            return lambda out, batch: row_shar_loss(
                out, batch, n_lanes=n_lanes, row_size=row_size,
                lambda_cls=lam)
        if head_type == "GridSeg":
            from ..models.row_head import grid_seg_loss
            n_classes = cfg.heads.num_classes
            ds_type = cfg.get("dataset_type", "LaserLane")
            return lambda out, batch: grid_seg_loss(
                out, batch, num_classes=n_classes, dataset_type=ds_type)
        hp = head_hparams(cfg)
        return lambda out, batch: column_proposal_loss(out, batch, hp)

    def resume_latest(self) -> bool:
        """Crash recovery: restore the newest checkpoint under
        ``<log_dir>/ckpt`` (an ``epoch_N`` before ``best``), optimizer,
        scheduler, step and generator included (a generator saved on
        another device type is reseeded, `checkpoint.py::load_model`).
        True if one was found."""
        ckpt_dir = os.path.join(self.log_dir, "ckpt")
        if not os.path.isdir(ckpt_dir):
            return False
        tags = [d for d in os.listdir(ckpt_dir)
                if os.path.isdir(os.path.join(ckpt_dir, d))]
        if not tags:
            return False

        def key(t):
            return (1, int(t.split("_")[1])) if t.startswith("epoch_") \
                else (0, 0)
        tag = sorted(tags, key=key)[-1]
        load_model(os.path.join(ckpt_dir, tag), self.state,
                   self.cfg.get("seed", 0))
        return True

    # -- logging -----------------------------------------------------------
    def _log(self, tag: str, record: Dict):
        # rank 0 only: every rank holds the same merged numbers, and
        # concurrent appends to one JSONL would interleave
        if not is_main_process():
            return
        record = {k: (float(v) if isinstance(v, (torch.Tensor, np.ndarray,
                                                 np.floating)) else v)
                  for k, v in record.items()}
        with open(os.path.join(self.log_dir, f"{tag}.jsonl"), "a") as f:
            f.write(json.dumps(record) + "\n")
        self._tb_log(tag, record)

    def _tb_log(self, tag: str, record: Dict):
        """Optional TensorBoard scalars (reference `runner.py:84,188-192`,
        JAX `runner.py:288-302`); skipped when tensorboard does not
        import."""
        if not hasattr(self, "_tb"):
            try:
                from torch.utils.tensorboard import SummaryWriter
                self._tb = SummaryWriter(self.log_dir)
            except Exception:
                self._tb = None
        if self._tb is None:
            return
        step = int(record.get("iter", record.get("epoch", 0)))
        for k, v in record.items():
            if isinstance(v, float) and k not in ("iter", "epoch"):
                self._tb.add_scalar(f"{tag}/{k}", v, step)

    # -- batches -------------------------------------------------------------
    def _mono_squeeze(self, v: np.ndarray) -> bool:
        """Whether to ship this uint8 image batch as one channel
        (``cfg.dataset_mono_bev`` pins it; unset, the content decides, in
        one process only: across ranks a per-batch content check could
        disagree, so the squeeze stays off)."""
        if v.ndim != 4 or v.shape[-1] != 3:
            return False
        flag = self.cfg.get("dataset_mono_bev")
        if flag is not None:
            return bool(flag)
        if get_world_size() > 1:
            return False
        return is_mono_batch(v)

    def _upload(self, v) -> torch.Tensor:
        t = v if isinstance(v, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(v))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def _device_batch(self, batch: Dict) -> Dict[str, torch.Tensor]:
        db = {}
        bf16 = self.cfg.get("train_compute_dtype") == "bfloat16"
        u8_ok = not self.cfg.get("dataset_color_augment", False) \
            and not self.use_lidar
        for k, v in batch.items():
            if k not in TRAIN_BATCH_KEYS or isinstance(v, list):
                continue
            if self.use_lidar and k == "proj":
                continue  # raw-point training never reads the BEV image
            if k in self._INT_SHIP:
                v = np.asarray(v).astype(self._INT_SHIP[k], copy=False)
            elif u8_ok and k in self._U8_ROUNDTRIP:
                v = np.rint(np.asarray(v, np.float32) * 255.0).astype(
                    np.uint8)
                if k == "proj" and self._mono_squeeze(v):
                    v = v[..., :1]
            elif bf16 and k in self._BF16_SHIP:
                v = torch.from_numpy(np.ascontiguousarray(
                    v, np.float32)).to(torch.bfloat16)
            db[k] = self._upload(v)
        return db

    def _eval_input(self, batch: Dict):
        """Forward input for eval and inference: the LiDAR points dict, or
        the tile shipped as uint8 (one channel when mono) and divided by
        255 in float32 on the device."""
        if self.use_lidar:
            return {"points": self._upload(np.asarray(batch["points"],
                                                      np.float32)),
                    "points_mask": self._upload(np.asarray(
                        batch["points_mask"], bool))}
        proj = np.asarray(batch["proj"], np.float32)
        if self.cfg.get("dataset_color_augment", False):
            return self._upload(proj)
        v = np.rint(proj * 255.0).astype(np.uint8)
        if self._mono_squeeze(v):
            v = v[..., :1]
        x = self._upload(v).float() / 255.0
        return x.expand(*x.shape[:-1], 3).contiguous()

    def _eval_decode(self, batch: Dict) -> Dict[str, torch.Tensor]:
        """Forward + lane decode of one batch, in eval mode, float32; the
        decode keys the host postprocess reads, still on the device."""
        from ..decode.lane_decode import decode_lanes, host_decode_view

        return eval_step(self.model, self._eval_input(batch),
                         lambda out: host_decode_view(decode_lanes(
                             out, self.cfg)))

    def _eval_grid(self, batch: Dict) -> Dict[str, torch.Tensor]:
        """Forward + the KLane head's device decode: RowSharNotReducRef's
        masked argmax maps (`decode_row_lanes`), GridSeg's raw ``conf`` and
        ``cls``."""
        from ..decode.row_decode import decode_row_lanes

        def decode(out):
            if self.head_type == "RowSharNotReducRef":
                return decode_row_lanes(out, self.cfg.number_lanes)
            return {"conf": out["conf"], "cls": out["cls"]}
        return eval_step(self.model, self._eval_input(batch), decode)

    def _eval_seg(self, batch: Dict) -> Dict[str, torch.Tensor]:
        """Forward + `segmentor_infer`: ``seg`` and ``endp`` maps."""
        from ..decode.seg_infer import segmentor_infer

        return eval_step(self.model, self._eval_input(batch),
                         lambda out: segmentor_infer(
                             out, seg_thre=self.cfg.get("seg_thre", 0.1),
                             n_lanes=self.cfg.number_lanes))

    @staticmethod
    def _host(dec: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
        return {k: v.cpu().numpy() for k, v in dec.items()}

    @staticmethod
    def _merge_metrics(scalars: Dict, counts: Optional[Dict] = None):
        """Merge per-rank metric means and counts over the ranks (JAX
        `runner.py:409-421`): the mean of the means (every rank scores the
        same number of tiles) and the sum of the counts."""
        if get_world_size() == 1:
            return scalars, counts
        gathered = all_gather_host((scalars, counts))
        merged = {k: float(np.mean([g[0][k] for g in gathered]))
                  for k in scalars}
        if counts is not None:
            counts = {k: sum(g[1][k] for g in gathered) for k in counts}
        return merged, counts

    # -- loops --------------------------------------------------------------
    def _loop(self, batches, device_fn, host_fn, max_batches):
        """The eval and export loops (`engine/pipeline.py::pipelined`):
        ``device_fn`` here, ``host_fn`` on ``cfg.validate_workers`` threads
        (default 4; inline on a host of two cores or fewer, where the
        overlap has no spare core to run on)."""
        default_workers = 4 if (os.cpu_count() or 1) > 2 else 0
        return pipelined(batches, device_fn, host_fn,
                         int(self.cfg.get("validate_workers",
                                          default_workers)), max_batches)

    def train(self, max_iters: Optional[int] = None):
        cfg = self.cfg
        log_every = int(cfg.get("log_every", 10))
        loader = build_dataloader(cfg.dataset.train, cfg, is_train=True)
        it_count = 0
        for epoch in range(cfg.epochs):
            for batch in loader:
                stats = self.train_step(self.state, self._device_batch(batch))
                if it_count % log_every == 0:
                    self._log("train", {"epoch": epoch, "iter": it_count,
                                        **stats})
                it_count += 1
                if max_iters is not None and it_count >= max_iters:
                    return
            if (epoch + 1) % cfg.get("eval_ep", 1) == 0:
                self.validate(epoch)
            if (epoch + 1) % cfg.get("save_ep", 5) == 0:
                save_model(self.log_dir, self.state, f"epoch_{epoch + 1}")

    def validate(self, epoch: int = 0, max_batches: Optional[int] = None,
                 loader=None) -> Dict:
        cfg = self.cfg
        if loader is None:
            split = cfg.dataset.get("val") or cfg.dataset.test
            loader = build_dataloader(split, cfg, is_train=False)
        if cfg.net.type == "Segmentor":
            metrics = self._validate_seg(loader, max_batches)
        elif self.head_type in KLANE_HEADS:
            metrics = self._validate_grid(loader, max_batches)
        else:
            metrics = self._validate_lanes(loader, max_batches)
        metric = metrics.get("composite", metrics.get("val_loss_neg", 0.0))
        self._log("val", {"epoch": epoch, **metrics})
        if metric > self.best_metric:
            self.best_metric = metric
            save_model(self.log_dir, self.state, "best")
        return metrics

    def _validate_seg(self, loader, max_batches) -> Dict:
        """Segmentor validation (`runner.py:465-491` there): per-tile
        binary segmentation F1 (10 px buffer) and endpoint F1 (20 px)."""
        from ..utils.metrics import (eval_metric_endp_detector,
                                     eval_metric_line_segmentor)

        def score(dec, batch):
            pred = self._host(dec)
            tiles = []
            for b in range(batch["proj"].shape[0]):
                seg = eval_metric_line_segmentor(
                    pred["seg"][b], batch["mask"][b], buffer_px=10)
                endp = eval_metric_endp_detector(
                    np.argwhere(pred["endp"][b] > 0), batch["endp_map"][b],
                    r_thre=20)
                tiles.append((seg["f1"], endp["f1"]))
            return tiles
        scores = [s for r in self._loop(loader, self._eval_seg, score,
                                        max_batches) for s in r]
        seg_f1 = float(np.mean([s[0] for s in scores])) if scores else 0.0
        endp_f1 = float(np.mean([s[1] for s in scores])) if scores else 0.0
        scalars, _ = self._merge_metrics({"seg_f1": seg_f1,
                                          "endp_f1": endp_f1})
        seg_f1, endp_f1 = scalars["seg_f1"], scalars["endp_f1"]
        return {"seg_f1": seg_f1, "endp_f1": endp_f1,
                "composite": 0.9 * seg_f1 + 0.1 * endp_f1}

    def _validate_grid(self, loader, max_batches) -> Dict:
        """KLane grid validation (reference `runner.py:257-322`): buffered
        confidence F1 of the predicted lane grid against ``label != 255``
        over the first ``heads.row_size`` columns (GridSeg, which has no
        ``row_size``: the whole label grid)."""
        from ..utils.metrics import grid_measures
        cfg = self.cfg

        def score(dec, batch):
            dec = self._host(dec)
            if self.head_type == "RowSharNotReducRef":
                conf_pred = dec["conf"]
            else:
                conf_pred = (dec["conf"] > cfg.get("conf_thr", 0.3)).astype(
                    np.float64)
            row_size = int(cfg.heads.get("row_size", batch["label"].shape[2]))
            conf_label = (batch["label"][:, :, :row_size] != 255).astype(
                np.float64)
            return [grid_measures(conf_label[b], conf_pred[b])["f1"]
                    for b in range(conf_pred.shape[0])]
        f1s = [v for r in self._loop(loader, self._eval_grid, score,
                                     max_batches) for v in r]
        f1 = float(np.mean(f1s)) if f1s else 0.0
        f1 = self._merge_metrics({"conf_f1": f1})[0]["conf_f1"]
        return {"conf_f1": f1, "composite": f1}

    def _validate_lanes(self, loader, max_batches) -> Dict:
        """Lane-coordinate validation (reference `runner.py:223-353`): the
        host postprocess (readback, tracker, NMS, metrics) on the loop's
        workers, the sums on this thread."""
        from ..decode.postprocess import lane_maps_from_decode
        from ..utils.metrics import (cal_coor_measures,
                                     eval_metric_endp_detector,
                                     eval_metric_line_segmentor,
                                     prf_from_counts)
        cfg = self.cfg
        buff = cfg.get("validate_buffer", 10)
        img_size = cfg.list_img_size_xy[0]

        def score(dec, batch):
            maps = lane_maps_from_decode(self._host(dec), cfg)
            coor, endp = [], []
            sem = None
            for b in range(len(batch["lc_coor_raw"])):
                m = cal_coor_measures(batch["lc_coor_raw"][b],
                                      maps["cls_offset_smooth"][b][:, :, 0],
                                      buffer_px=buff, img_size=img_size)
                coor.append(m["f1"])
                e = eval_metric_endp_detector(
                    np.argwhere(maps["endp_by_cls"][b] > 0),
                    batch["endp_map"][b], r_thre=2 * buff)
                endp.append((e["f1"], e["acc"], e["recall"]))
                if "mask" in batch:
                    # per-class semantic F1 on the re-rendered lane map,
                    # counts pooled across classes and tiles (reference
                    # `metric_utils.py:443-481`, `runner.py:779-787`)
                    m = eval_metric_line_segmentor(
                        maps["semantic_line"][b], batch["mask"][b],
                        bi_seg=False, semantics=2, buffer_px=buff)
                    if sem is None:
                        sem = {k: 0 for k in ("tp", "n_pred", "dg", "n_gt")}
                    for k in sem:
                        sem[k] += m[k]
            return coor, endp, sem

        results = self._loop(loader, self._eval_decode, score, max_batches)
        coor_f1s = [v for r in results for v in r[0]]
        endp_f1s = [v[0] for r in results for v in r[1]]
        endp_accs = [v[1] for r in results for v in r[1]]
        endp_recs = [v[2] for r in results for v in r[1]]
        sem_counts = {k: 0 for k in ("tp", "n_pred", "dg", "n_gt")}
        saw_mask = False
        for r in results:
            if r[2] is not None:
                saw_mask = True
                for k in sem_counts:
                    sem_counts[k] += r[2][k]
        coor = float(np.mean(coor_f1s)) if coor_f1s else 0.0
        endp = float(np.mean(endp_f1s)) if endp_f1s else 0.0
        scalars, sem_counts = self._merge_metrics(
            {"coor_f1": coor, "endp_f1": endp,
             "endp_acc": float(np.mean(endp_accs)) if endp_accs else 0.0,
             "endp_recall": float(np.mean(endp_recs)) if endp_recs
             else 0.0}, sem_counts if saw_mask else None)
        coor, endp = scalars["coor_f1"], scalars["endp_f1"]
        metrics = {**scalars, "composite": 0.9 * coor + 0.1 * endp}
        if saw_mask:
            acc, rec, f1 = prf_from_counts(**sem_counts)
            metrics["semantic_f1"] = f1
            metrics["semantic_acc"] = acc
            metrics["semantic_recall"] = rec
        return metrics

    def infer_and_export(self, loader, out_dir: str,
                         max_batches: Optional[int] = None,
                         write_view: bool = False) -> None:
        """Inference (reference `runner.py:690-868`): decode and
        postprocess every tile, one lane JSON per tile, and with
        ``write_view`` an overlay PNG of the lanes and endpoints."""
        from ..decode.postprocess import lane_maps_from_decode

        os.makedirs(out_dir, exist_ok=True)

        def export(dec, item):
            i, batch = item
            maps = lane_maps_from_decode(self._host(dec), self.cfg)
            for j, name in enumerate(_tile_names(batch, i)):
                _write_lanes(out_dir, name, maps["cls_offset_smooth"][j])
                if write_view:
                    from ..utils.vis_utils import render_lane_overlays
                    _write_png(out_dir, f"{name}_overlay.png",
                               render_lane_overlays(
                                   batch["proj"][j],
                                   maps["cls_offset_smooth"][j],
                                   maps["endp_by_cls"][j]))
        self._loop(enumerate(loader), lambda item: self._eval_decode(item[1]),
                   export, max_batches)

    def infer_grid_and_export(self, loader, out_dir: str,
                              max_batches: Optional[int] = None,
                              write_view: bool = False) -> None:
        """KLane export driver (reference ``infer_lane``, `runner.py:473-604`):
        decode the row or grid head, smooth each lane's vertices, one lane
        JSON per tile, and with ``write_view`` an overlay PNG and the RGB
        class map (`:552-564` ``rgb_conf_cls_idx``)."""
        from ..decode.row_decode import row_lane_maps

        os.makedirs(out_dir, exist_ok=True)

        def export(dec, item):
            i, batch = item
            maps = row_lane_maps(self._host(dec), self.cfg, self.head_type)
            for j, name in enumerate(_tile_names(batch, i)):
                _write_lanes(out_dir, name, maps["cls_offset_smooth"][j])
                if write_view:
                    from ..utils.vis_utils import (render_lane_overlays,
                                                   rgb_cls_map)
                    _write_png(out_dir, f"{name}_overlay.png",
                               render_lane_overlays(
                                   batch["proj"][j],
                                   maps["cls_offset_smooth"][j]))
                    _write_png(out_dir, f"{name}_grid.png",
                               rgb_cls_map(maps["cls_idx"][j]))
        self._loop(enumerate(loader), lambda item: self._eval_grid(item[1]),
                   export, max_batches)

    def infer_segmentor_and_export(self, loader,
                                   out_dir: Optional[str] = None,
                                   max_batches: Optional[int] = None,
                                   write_view: bool = False) -> Dict:
        """Segmentor driver (reference `runner.py:945-1036`): per-class
        semantic and binary geometry precision, recall and F1, counts
        pooled over the split, and with ``write_view`` the segmentation and
        skeleton overlay PNGs (`postprojector.py:221-261`)."""
        from ..decode.seg_infer import segmentor_displays
        from ..utils.metrics import eval_metric_line_segmentor, \
            prf_from_counts

        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
        buff = self.cfg.get("validate_buffer", 10)

        def score(dec, item):
            i, batch = item
            pred = self._host(dec)
            names = _tile_names(batch, i)
            tiles = []
            for b in range(batch["proj"].shape[0]):
                tiles.append({key: eval_metric_line_segmentor(
                    pred["seg"][b], batch["mask"][b], bi_seg=bi,
                    semantics=2, buffer_px=buff)
                    for key, bi in (("semantic", False), ("coor", True))})
                if write_view and out_dir:
                    seg_img, skel_img = segmentor_displays(
                        batch["proj"][b], pred["seg"][b], pred["endp"][b])
                    _write_png(out_dir, f"{names[b]}_segmentor.png", seg_img)
                    _write_png(out_dir, f"{names[b]}_seg_skeleton.png",
                               skel_img)
            return tiles
        counts = {k: {"tp": 0, "n_pred": 0, "dg": 0, "n_gt": 0}
                  for k in ("coor", "semantic")}
        for tiles in self._loop(enumerate(loader),
                                lambda item: self._eval_seg(item[1]), score,
                                max_batches):
            for tile in tiles:
                for key, m in tile.items():
                    for k in counts[key]:
                        counts[key][k] += m[k]
        metrics = {}
        for key, c in counts.items():
            # pooled over every rank's tiles (the JAX method logs rank 0's)
            c = self._merge_metrics({}, c)[1]
            acc, rec, f1 = prf_from_counts(**c)
            metrics.update({f"{key}_conf_prec": acc, f"{key}_conf_rec": rec,
                            f"{key}_conf_f1": f1})
        self._log("segmentor_infer", metrics)
        return metrics


def _tile_names(batch: Dict, i: int):
    return batch.get("image_name", [f"b{i}_{j}" for j in
                                    range(len(batch["proj"]))])


def _write_lanes(out_dir: str, name: str, ply: np.ndarray) -> None:
    from ..tools.export_lanes import lane_records
    with open(os.path.join(out_dir, f"{name}.json"), "w") as f:
        json.dump(lane_records(ply), f)


def _write_png(out_dir: str, name: str, img: np.ndarray) -> None:
    from PIL import Image
    Image.fromarray(img).save(os.path.join(out_dir, name))


def load_config_and_runner(path_config: str, log_dir: Optional[str] = None,
                           device: Union[str, torch.device] = "cuda"):
    """(Config, Runner) of a config file (JAX `runner.py:643-647`,
    reference `runner.py:57-66`), on the card unless ``device`` says
    otherwise."""
    from ..config.config import Config
    cfg = Config.fromfile(path_config)
    return cfg, Runner(cfg, log_dir=log_dir, device=device)
