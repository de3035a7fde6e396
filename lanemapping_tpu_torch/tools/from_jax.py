"""Carry weights across from the JAX package: flax trees -> ``state_dict``.

The inverse of `lanemapping_tpu/tools/port_torch_ckpt.py` (``build_rules``
and ``port_state_dict``): the same (torch key, flax path, layout) rules,
copied here, applied backwards.  The port's parameter names are the
reference's torch names, so the result loads with ``load_state_dict``, and
a reference ``.pth`` loads the same way without this module.

The LiDAR encoder has no torch reference (the reference's spconv encoder
has no dense counterpart): its torch names are the flax module names.

Layouts: flax conv HWIO -> torch OIHW; Dense [I,O] -> Linear [O,I];
Dense [I,O] -> Conv1d(k=1) [O,I,1]; BatchNorm scale/bias + batch_stats
mean/var -> weight/bias/running_mean/running_var.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _conv_inv(w):  # flax HWIO -> torch OIHW
    return np.transpose(w, (3, 2, 0, 1))


def _dense_inv(w):  # flax [I,O] -> torch linear [O,I]
    return np.transpose(w, (1, 0))


def _conv1d_dense_inv(w):  # flax [I,O] -> torch conv1d k=1 [O,I,1]
    return np.transpose(w, (1, 0))[:, :, None]


def _resnet_block_rules(t_prefix: str, j_prefix: str, n_blocks: int):
    rules = []
    for i in range(n_blocks):
        t = f"{t_prefix}.{i}"
        j = f"{j_prefix}/block{i}"
        rules += [
            (f"{t}.conv1.weight", f"{j}/conv1/kernel", _conv_inv),
            (f"{t}.conv2.weight", f"{j}/conv2/kernel", _conv_inv),
            (f"{t}.bn1", f"{j}/bn1", "bn"),
            (f"{t}.bn2", f"{j}/bn2", "bn"),
            (f"{t}.downsample.0.weight", f"{j}/downsample_conv/kernel",
             _conv_inv),
            (f"{t}.downsample.1", f"{j}/downsample_bn", "bn"),
        ]
    return rules


def _transformer_rules(t_prefix: str, j_prefix: str, depth: int) -> list:
    R = []
    for d in range(depth):
        t = f"{t_prefix}.layers.{d}"
        j = f"{j_prefix}/block{d}"
        R += [
            (f"{t}.0.norm.weight", f"{j}/norm1/scale", None),
            (f"{t}.0.norm.bias", f"{j}/norm1/bias", None),
            (f"{t}.0.fn.to_qkv.weight", f"{j}/attn/to_qkv/kernel", _dense_inv),
            (f"{t}.0.fn.to_out.0.weight", f"{j}/attn/to_out/kernel",
             _dense_inv),
            (f"{t}.0.fn.to_out.0.bias", f"{j}/attn/to_out/bias", None),
            (f"{t}.1.norm.weight", f"{j}/norm2/scale", None),
            (f"{t}.1.norm.bias", f"{j}/norm2/bias", None),
            (f"{t}.1.fn.net.0.weight", f"{j}/mlp/fc1/kernel", _dense_inv),
            (f"{t}.1.fn.net.0.bias", f"{j}/mlp/fc1/bias", None),
            (f"{t}.1.fn.net.3.weight", f"{j}/mlp/fc2/kernel", _dense_inv),
            (f"{t}.1.fn.net.3.bias", f"{j}/mlp/fc2/bias", None),
        ]
    return R


def _lidar_encoder_rules() -> list:
    """LidarEncoder: the torch names are the flax module names."""
    R = []
    zf = "pcencoder.zfold_encoder"
    jz = "pcencoder/zfold_encoder"
    R += [(f"{zf}.stem.weight", f"{jz}/stem/kernel", _conv_inv),
          (f"{zf}.stem_bn", f"{jz}/stem_bn", "bn"),
          (f"{zf}.out.weight", f"{jz}/out/kernel", _conv_inv),
          (f"{zf}.out.bias", f"{jz}/out/bias", None)]
    for i in range(3):
        for conv in ("conv1", "conv2", "proj"):
            R.append((f"{zf}.s{i}_{conv}.weight", f"{jz}/s{i}_{conv}/kernel",
                      _conv_inv))
        for bn in ("bn1", "bn2", "proj_bn"):
            R.append((f"{zf}.s{i}_{bn}", f"{jz}/s{i}_{bn}", "bn"))
    for conv in ("fea_aligner", "fea_conv", "output_layer_binary_seg",
                 "output_layer_endp", "output_layer_fea"):
        R += [(f"pcencoder.{conv}.weight", f"pcencoder/{conv}/kernel",
               _conv_inv),
              (f"pcencoder.{conv}.bias", f"pcencoder/{conv}/bias", None)]
    for bn in ("fea_aligner_bn", "fea_conv_bn"):
        R.append((f"pcencoder.{bn}", f"pcencoder/{bn}", "bn"))
    return R


def _postprojector2_rules(resnet_layers) -> list:
    R = []
    enc, fpn = "pcencoder", "pcencoder.fpn"
    R += [(f"{fpn}.conv1.weight", f"{enc}/conv1/kernel", _conv_inv),
          (f"{fpn}.bn1", f"{enc}/bn1", "bn"),
          (f"{fpn}.out.weight", f"{enc}/out_conv/kernel", _conv_inv)]
    for li, nb in enumerate(resnet_layers, start=1):
        R += _resnet_block_rules(f"{fpn}.layer{li}", f"{enc}/layer{li}", nb)
    for name in ("toplayer", "smooth1", "smooth2", "smooth3", "latlayer1",
                 "latlayer2", "latlayer3", "semantic_branch",
                 "semantic_branch2", "conv2", "conv3", "feature_layer",
                 "output_layer_binary_seg", "output_layer_endp"):
        R += [(f"{fpn}.{name}.weight", f"{enc}/{name}/kernel", _conv_inv),
              (f"{fpn}.{name}.bias", f"{enc}/{name}/bias", None)]
    for gn in ("gn11", "gn12", "gn21", "gn22"):
        R += [(f"{fpn}.{gn}.weight", f"{enc}/{gn}/scale", None),
              (f"{fpn}.{gn}.bias", f"{enc}/{gn}/bias", None)]
    return R


def build_rules(resnet_layers=(3, 4, 6, 3), vit_depth=3,
                pcencoder="PostProjector2") -> list:
    """(torch_key, flax_path, inverse layout) triples for Detector1stage
    with PostProjector2 or LidarEncoder + VitSegNet + ColumnProposal2 (live
    path).  Rules whose flax path is absent (a missing trunk stage, an
    unused lateral, a projection the encoder does not have) are skipped by
    ``params_from_jax``."""
    R = _lidar_encoder_rules() if pcencoder == "LidarEncoder" \
        else _postprojector2_rules(resnet_layers)
    bb = "backbone"
    R += [(f"{bb}.to_patch_embedding.1.weight", f"{bb}/patch_embed/kernel",
           _dense_inv),
          (f"{bb}.to_patch_embedding.1.bias", f"{bb}/patch_embed/bias", None),
          (f"{bb}.pos_embedding", f"{bb}/pos_embedding", None)]
    R += _transformer_rules(f"{bb}.transformer", f"{bb}/transformer",
                            vit_depth)

    hd = "heads"
    seq = [
        ("endpoint.0", "endpoint_conv1", "conv"),
        ("endpoint.2", "endpoint_bn", "bn"),
        ("endpoint.3", "endpoint_conv2", "conv"),
        ("head_common_layers.0", "common_conv1", "conv"),
        ("head_common_layers.1", "common_bn1", "bn"),
        ("head_common_layers.2", "common_conv2", "conv"),
        ("head_common_layers.3", "common_bn2", "bn"),
        ("orient.0", "orient_conv1", "conv"),
        ("orient.1", "orient_bn", "bn"),
        ("orient.2", "orient_conv2", "conv"),
        ("bi_seg_proposal", "bi_seg_proposal", "conv"),
    ]
    for t_name, j_name, kind in seq:
        if kind == "conv":
            R += [(f"{hd}.{t_name}.weight", f"{hd}/{j_name}/kernel",
                   _conv_inv),
                  (f"{hd}.{t_name}.bias", f"{hd}/{j_name}/bias", None)]
        else:
            R += [(f"{hd}.{t_name}", f"{hd}/{j_name}", "bn")]
    R += [(f"{hd}.proposal_confidence.1.weight",
           f"{hd}/proposal_confidence/kernel", _dense_inv),
          (f"{hd}.proposal_confidence.1.bias",
           f"{hd}/proposal_confidence/bias", None)]
    for head in ("ext2", "cls2", "offset2"):
        R += [(f"{hd}.{head}.0.weight", f"{hd}/{head}_fc1/kernel",
               _conv1d_dense_inv),
              (f"{hd}.{head}.0.bias", f"{hd}/{head}_fc1/bias", None),
              (f"{hd}.{head}.1", f"{hd}/{head}_bn", "bn"),
              (f"{hd}.{head}.2.weight", f"{hd}/{head}_fc2/kernel",
               _conv1d_dense_inv),
              (f"{hd}.{head}.2.bias", f"{hd}/{head}_fc2/bias", None)]
    return R


def _get(tree: Dict, path: str):
    node = tree
    for p in path.split("/"):
        if not isinstance(node, dict) or p not in node:
            return None
        node = node[p]
    return node


def params_from_jax(params: Dict, batch_stats: Dict, rules=None
                    ) -> Dict[str, torch.Tensor]:
    """Flax ``params`` / ``batch_stats`` trees (nested dicts of numpy
    arrays) -> the port's ``state_dict`` (float32 CPU tensors)."""
    rules = rules or build_rules()
    sd: Dict[str, torch.Tensor] = {}

    def put(key, value):
        sd[key] = torch.from_numpy(np.array(value, np.float32))  # a copy

    for t_key, j_path, tf in rules:
        if tf == "bn":
            for suffix, tree, leaf in (("weight", params, "scale"),
                                       ("bias", params, "bias"),
                                       ("running_mean", batch_stats, "mean"),
                                       ("running_var", batch_stats, "var")):
                v = _get(tree, f"{j_path}/{leaf}")
                if v is not None:
                    put(f"{t_key}.{suffix}", v)
            continue
        v = _get(params, j_path)
        if v is not None:
            put(t_key, v if tf is None else tf(np.asarray(v)))
    return sd


def rules_for(cfg) -> list:
    """``build_rules`` sized to a config's encoder, trunk and correlator
    depth."""
    from ..models.resnet_fpn import RESNET_LAYERS
    return build_rules(
        resnet_layers=RESNET_LAYERS[cfg.pcencoder.get("resnet", "resnet34")],
        vit_depth=cfg.backbone.get("depth", 3) if "backbone" in cfg else 0,
        pcencoder=cfg.pcencoder.type)


def load_jax_weights(model: torch.nn.Module, params: Dict, batch_stats: Dict,
                     cfg) -> torch.nn.Module:
    """Load JAX weights into a port model; every parameter and buffer except
    BatchNorm's ``num_batches_tracked`` must be covered."""
    sd = params_from_jax(params, batch_stats, rules_for(cfg))
    missing, unexpected = model.load_state_dict(sd, strict=False)
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    if missing or unexpected:
        raise KeyError(f"JAX weights do not cover the port model: missing "
                       f"{missing[:8]}, unexpected {unexpected[:8]}")
    return model
