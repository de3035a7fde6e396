"""Carry weights across from the JAX package: flax trees -> ``state_dict``.

The inverse of `lanemapping_tpu/tools/port_torch_ckpt.py` (``build_rules``
and ``port_state_dict``): the same (torch key, flax path, layout) rules,
copied here, applied backwards.  The port's parameter names are the
reference's torch names, so the result loads with ``load_state_dict``, and
a reference ``.pth`` loads the same way without this module.

The LiDAR encoder has no torch reference (the reference's spconv encoder
has no dense counterpart), nor have the MixSegNet correlator, the legacy
ResNet projector, the KLane heads and ColumnProposal2's query decoder
here, nor the modules with no torch reference at hand (the
RowSharNotReducRef_Base head, the ResnetFPN family, Swin, the FPN's
``s2d_stem`` and ``endp_head_extra`` layers): their torch names are the
flax module names.  ``PerLaneConvHead``
keeps flax's ``[N, I, O]`` weights, the query decoder's attention flax's
DenseGeneral kernels.  ColumnProposal2's ``column_att`` branch keeps the
reference's names, with one ``emb_{i}`` per row of flax's ``prop_emb``.

Layouts: flax conv HWIO -> torch OIHW; Dense [I,O] -> Linear [O,I];
Dense [I,O] -> Conv1d(k=1) [O,I,1]; BatchNorm scale/bias + batch_stats
mean/var -> weight/bias/running_mean/running_var.

``adam_state_from_jax`` carries an optax Adam state (``mu``, ``nu`` trees
laid out like the params, and ``count``) into a ``torch.optim.Adam`` /
``AdamW`` and its ``LambdaLR``, so both packages can go on from one
mid-training state.
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
          (f"{fpn}.conv1_s2d.weight", f"{enc}/conv1_s2d/kernel", _conv_inv),
          (f"{fpn}.bn1", f"{enc}/bn1", "bn"),
          (f"{fpn}.out.weight", f"{enc}/out_conv/kernel", _conv_inv)]
    for li, nb in enumerate(resnet_layers, start=1):
        R += _resnet_block_rules(f"{fpn}.layer{li}", f"{enc}/layer{li}", nb)
    for name in ("toplayer", "smooth1", "smooth2", "smooth3", "latlayer1",
                 "latlayer2", "latlayer3", "semantic_branch",
                 "semantic_branch2", "conv2", "conv3", "feature_layer",
                 "output_layer_binary_seg", "output_layer_endp",
                 "endp_extra"):
        R += [(f"{fpn}.{name}.weight", f"{enc}/{name}/kernel", _conv_inv),
              (f"{fpn}.{name}.bias", f"{enc}/{name}/bias", None)]
    for gn in ("gn11", "gn12", "gn21", "gn22", "gn_endp_extra"):
        R += [(f"{fpn}.{gn}.weight", f"{enc}/{gn}/scale", None),
              (f"{fpn}.{gn}.bias", f"{enc}/{gn}/bias", None)]
    return R


def _conv_rules(t: str, j: str, bias: bool = True) -> list:
    R = [(f"{t}.weight", f"{j}/kernel", _conv_inv)]
    return R + [(f"{t}.bias", f"{j}/bias", None)] if bias else R


def _dense_rules(t: str, j: str) -> list:
    return [(f"{t}.weight", f"{j}/kernel", _dense_inv),
            (f"{t}.bias", f"{j}/bias", None)]


def _ln_rules(t: str, j: str) -> list:
    return [(f"{t}.weight", f"{j}/scale", None),
            (f"{t}.bias", f"{j}/bias", None)]


def _resnet_projector_rules(resnet_layers) -> list:
    """ResNetProjector (the legacy ``PostProjector``)."""
    R = _conv_rules("pcencoder.conv1", "pcencoder/conv1", bias=False)
    R += [("pcencoder.bn1", "pcencoder/bn1", "bn")]
    for li, nb in enumerate(resnet_layers, start=1):
        R += _resnet_block_rules(f"pcencoder.layer{li}", f"pcencoder/layer{li}",
                                 nb)
    return R + _conv_rules("pcencoder.out_conv", "pcencoder/out_conv",
                           bias=False)


def _vit_rules(depth: int) -> list:
    bb = "backbone"
    R = [(f"{bb}.to_patch_embedding.1.weight", f"{bb}/patch_embed/kernel",
          _dense_inv),
         (f"{bb}.to_patch_embedding.1.bias", f"{bb}/patch_embed/bias", None),
         (f"{bb}.pos_embedding", f"{bb}/pos_embedding", None)]
    R += _transformer_rules(f"{bb}.transformer", f"{bb}/transformer", depth)
    return R + _conv_rules(f"{bb}.shared_mlp", f"{bb}/shared_mlp")


def _mixsegnet_rules(depth: int) -> list:
    bb = "backbone"
    R = _dense_rules(f"{bb}.patch_embed", f"{bb}/patch_embed")
    for i in range(depth):
        t, j = f"{bb}.mixers.{i}", f"{bb}/mixer{i}"
        R += _ln_rules(f"{t}.norm1", f"{j}/norm1")
        R += _ln_rules(f"{t}.norm2", f"{j}/norm2")
        for fc in ("token_fc1", "token_fc2", "chan_fc1", "chan_fc2"):
            R += _dense_rules(f"{t}.{fc}", f"{j}/{fc}")
    R += _ln_rules(f"{bb}.norm", f"{bb}/norm")
    return R + _conv_rules(f"{bb}.shared_mlp", f"{bb}/shared_mlp")


def _column_att_rules(depth: int, stages: int, num_prop: int) -> list:
    """The ``column_att`` branch under the reference's names (JAX
    `port_torch_ckpt.py:141-165`): the Conv_Pool_2d stack, the tokeniser,
    one ``emb_{i}`` per proposal (row i of flax's ``prop_emb`` table), the
    lane correlator and its LayerNorm, the expander."""
    hd = "heads"
    glp, jglp = f"{hd}.generate_line_proposal.0.layers", \
        f"{hd}/generate_line_proposal"
    R = _conv_rules(f"{glp}.0", f"{jglp}/conv0")
    for i in range(stages):
        R += [(f"{glp}.{i + 1}.1", f"{jglp}/bn{i}", "bn")]
        R += _conv_rules(f"{glp}.{i + 1}.2", f"{jglp}/conv{i + 1}")
    R += _dense_rules(f"{hd}.to_token.1", f"{hd}/to_token")
    R += [(f"{hd}.emb_{i}", f"{hd}/prop_emb", lambda v, i=i: v[i])
          for i in range(num_prop)]
    R += _transformer_rules(f"{hd}.tr_lane_correlator.0",
                            f"{hd}/tr_lane_correlator", depth)
    R += _ln_rules(f"{hd}.tr_lane_correlator.1", f"{hd}/tr_lane_norm")
    return R + _dense_rules(f"{hd}.line_expand.0", f"{hd}/line_expand")


def _column_decoder_rules(depth: int) -> list:
    """The query-decoder branch: flax names; the DenseGeneral kernels keep
    flax's layout."""
    hd = "heads"
    R = _dense_rules(f"{hd}.to_patch_embedding", f"{hd}/to_patch_embedding")
    R += [(f"{hd}.img_pe", f"{hd}/img_pe", None),
          (f"{hd}.query_embed", f"{hd}/query_embed", None)]
    R += _ln_rules(f"{hd}.kv_norm", f"{hd}/kv_norm")
    for d in range(depth):
        t, j = f"{hd}.dec{d}", f"{hd}/dec{d}"
        R += _ln_rules(f"{t}_norm1", f"{j}_norm1")
        R += _ln_rules(f"{t}_norm2", f"{j}_norm2")
        R += [(f"{t}_xattn.{m}.{w}", f"{j}_xattn/{m}/{leaf}", None)
              for m in ("query", "key", "value", "out")
              for w, leaf in (("weight", "kernel"), ("bias", "bias"))]
        R += _dense_rules(f"{t}_mlp.net.0", f"{j}_mlp/fc1")
        R += _dense_rules(f"{t}_mlp.net.3", f"{j}_mlp/fc2")
    R += _ln_rules(f"{hd}.dec_out_norm", f"{hd}/dec_out_norm")
    return R + _dense_rules(f"{hd}.reverse_query_embedding",
                            f"{hd}/reverse_query_embedding")


def _column_proposal_rules() -> list:
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
    R = []
    for t_name, j_name, kind in seq:
        if kind == "conv":
            R += _conv_rules(f"{hd}.{t_name}", f"{hd}/{j_name}")
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


def _row_shar_rules(depth: int) -> list:
    """RowSharNotReducRef: four PerLaneConvHeads ([N, I, O] weights as
    they are), the lane tokens and the lane correlator."""
    hd = "heads"
    R = []
    for head in ("ext1", "cls1", "ext2", "cls2"):
        R += [(f"{hd}.{head}.{w}", f"{hd}/{head}/{w}", None)
              for w in ("w1", "b1", "w2", "b2")]
        R += [(f"{hd}.{head}.bn", f"{hd}/{head}/bn", "bn")]
    R += _dense_rules(f"{hd}.to_token", f"{hd}/to_token")
    R += [(f"{hd}.lane_emb", f"{hd}/lane_emb", None)]
    R += _transformer_rules(f"{hd}.lane_correlator", f"{hd}/lane_correlator",
                            depth)
    R += _ln_rules(f"{hd}.corr_norm", f"{hd}/corr_norm")
    return R + _dense_rules(f"{hd}.from_token", f"{hd}/from_token")


def _row_shar_base_rules(depth: int, row_depth: int) -> list:
    """RowSharNotReducRef_Base: flax names; ``fc_reg1``/``fc_reg2`` only in
    ``endp_mode="Regr"`` (skipped when absent)."""
    hd = "heads"
    R = []
    for conv in ("gen_prop_conv1", "gen_prop_conv2", "common_conv1",
                 "common_conv2", "upsample_conv1", "upsample_conv2",
                 "endpoint_conv1", "endpoint_conv2", "orient_conv1",
                 "orient_conv2", "bi_seg_proposal"):
        R += _conv_rules(f"{hd}.{conv}", f"{hd}/{conv}")
    R += [(f"{hd}.{bn}", f"{hd}/{bn}", "bn")
          for bn in ("gen_prop_bn", "common_bn1", "common_bn2",
                     "upsample_bn1", "upsample_bn2", "endpoint_bn",
                     "orient_bn", "ext2_bn", "cls2_bn", "offset2_bn")]
    for dense in ("to_token", "proposal_confidence", "line_expand",
                  "fc_reg1", "fc_reg2", "to_token_row_seg_att",
                  "ext2_fc1", "ext2_fc2", "cls2_fc1", "cls2_fc2",
                  "offset2_fc1", "offset2_fc2"):
        R += _dense_rules(f"{hd}.{dense}", f"{hd}/{dense}")
    R += _ln_rules(f"{hd}.tr_lane_norm", f"{hd}/tr_lane_norm")
    R += _ln_rules(f"{hd}.tr_row_norm", f"{hd}/tr_row_norm")
    R += [(f"{hd}.prop_emb", f"{hd}/prop_emb", None)]
    R += _transformer_rules(f"{hd}.tr_lane_correlator",
                            f"{hd}/tr_lane_correlator", depth)
    return R + _transformer_rules(f"{hd}.tr_row_correlator",
                                  f"{hd}/tr_row_correlator", row_depth)


def family_rules() -> list:
    """The ResnetFPN family (flax names; the transposed convolutions keep
    the flax kernel unflipped, so they map as convolutions).  Rules for
    every stage, block kind and residual; the absent ones are skipped."""
    t = j = "backbone"
    R = []
    for s in range(5):
        R += _conv_rules(f"{t}.block{s}_conv", f"{j}/block{s}_conv")
        R += [(f"{t}.block{s}_bn", f"{j}/block{s}_bn", "bn")]
        R += _conv_rules(f"{t}.up{s}", f"{j}/up{s}")
        for r in range(2):
            tb, jb = f"{t}.block{s}_res{r}", f"{j}/block{s}_res{r}"
            for conv in ("conv1", "conv2", "conv_cbam"):
                R += _conv_rules(f"{tb}.{conv}", f"{jb}/{conv}")
            R += [(f"{tb}.bn1", f"{jb}/bn1", "bn"),
                  (f"{tb}.bn2", f"{jb}/bn2", "bn")]
            R += _dense_rules(f"{tb}.mlp1", f"{jb}/mlp1")
            R += _dense_rules(f"{tb}.mlp2", f"{jb}/mlp2")
    return R


def swin_rules(depths, prefix: str = "backbone") -> list:
    """SwinTransformer of stage ``depths`` (flax names)."""
    t, j = prefix, prefix.replace(".", "/")
    R = _conv_rules(f"{t}.patch_embed", f"{j}/patch_embed")
    R += _ln_rules(f"{t}.patch_norm", f"{j}/patch_norm")
    for i, depth in enumerate(depths):
        for d in range(depth):
            tb, jb = f"{t}.stage{i}_block{d}", f"{j}/stage{i}_block{d}"
            R += _ln_rules(f"{tb}.norm1", f"{jb}/norm1")
            R += _ln_rules(f"{tb}.norm2", f"{jb}/norm2")
            R += _dense_rules(f"{tb}.attn.qkv", f"{jb}/attn/qkv")
            R += _dense_rules(f"{tb}.attn.proj", f"{jb}/attn/proj")
            R += [(f"{tb}.attn.rel_bias", f"{jb}/attn/rel_bias", None)]
            R += _dense_rules(f"{tb}.fc1", f"{jb}/fc1")
            R += _dense_rules(f"{tb}.fc2", f"{jb}/fc2")
        R += _ln_rules(f"{t}.out_norm{i}", f"{j}/out_norm{i}")
        R += _ln_rules(f"{t}.merge{i}.norm", f"{j}/merge{i}/norm")
        R += [(f"{t}.merge{i}.reduction.weight",
               f"{j}/merge{i}/reduction/kernel", _dense_inv)]
    return R


_HEAD_CONVS = {"GridSeg": ("conf_fc1", "conf_fc2", "cls_fc1", "cls_fc2"),
               "PixelSeg": ("cls_fc0", "cls_fc1", "cls_fc2")}


def build_rules(resnet_layers=(3, 4, 6, 3), vit_depth=3,
                pcencoder="PostProjector2", backbone="VitSegNet",
                head="ColumnProposal2", head_depth=1, column_branch=None,
                num_prop=72, pool_stages=1, row_depth=1,
                swin_depths=(2, 2, 6, 2)) -> list:
    """(torch_key, flax_path, inverse layout) triples for a net of the
    given encoder, correlator (``None`` for none) and head (``None`` for
    the Segmentor); ``vit_depth`` is the correlator's depth and
    ``head_depth`` the row head's lane-correlator depth or that of
    ColumnProposal2's ``column_branch`` (``"column_att"`` with
    ``num_prop`` proposals and ``pool_stages`` stride-2 stages, or
    ``"column_transformer_decoder"``); ``row_depth`` is the depth of
    RowSharNotReducRef_Base's row transformer and ``swin_depths`` Swin's
    stage depths.  Rules whose flax
    path is absent (a missing trunk stage, an unused lateral, a projection
    the encoder does not have, a shared MLP the correlator does not use)
    are skipped by ``params_from_jax``."""
    R = {"LidarEncoder": _lidar_encoder_rules,
         "PostProjector": lambda: _resnet_projector_rules(resnet_layers),
         "PostProjector2": lambda: _postprojector2_rules(resnet_layers),
         }[pcencoder]()
    if backbone == "VitSegNet":
        R += _vit_rules(vit_depth)
    elif backbone == "MixSegNet":
        R += _mixsegnet_rules(vit_depth)
    elif backbone == "SwinTransformer":
        R += swin_rules(swin_depths)
    elif backbone is not None and backbone.startswith("ResnetFPN"):
        R += family_rules()
    if head == "ColumnProposal2":
        R += _column_proposal_rules()
        if column_branch == "column_att":
            R += _column_att_rules(head_depth, pool_stages, num_prop)
        elif column_branch == "column_transformer_decoder":
            R += _column_decoder_rules(head_depth)
    elif head == "RowSharNotReducRef":
        R += _row_shar_rules(head_depth)
    elif head == "RowSharNotReducRef_Base":
        R += _row_shar_base_rules(head_depth, row_depth)
    elif head in _HEAD_CONVS:
        for name in _HEAD_CONVS[head]:
            R += _conv_rules(f"heads.{name}", f"heads/{name}")
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
    """``build_rules`` for a config: its net, encoder and trunk, correlator
    and its depth, head and its lane-correlator depth."""
    from ..models.column_head import column_pool_stages
    from ..models.resnet_fpn import RESNET_LAYERS
    segmentor = cfg.net.type == "Segmentor"
    has_bb = "backbone" in cfg and not segmentor
    branch = next((f for f in ("column_att", "column_transformer_decoder")
                   if cfg.get(f, False)), None)
    return build_rules(
        resnet_layers=RESNET_LAYERS[cfg.pcencoder.get("resnet", "resnet34")],
        vit_depth=cfg.backbone.get("depth", 3) if has_bb else 0,
        pcencoder=cfg.pcencoder.type,
        backbone=cfg.backbone.type if has_bb else None,
        head=None if segmentor else cfg.heads.type,
        head_depth=cfg.heads.get("tr_depth", 1) if not segmentor else 0,
        column_branch=None if segmentor else branch,
        num_prop=cfg.heads.get("num_prop", 72) if not segmentor else 0,
        pool_stages=column_pool_stages(cfg.heads.row_size,
                                       cfg.heads.num_prop)
        if branch == "column_att" else 0,
        row_depth=cfg.heads.get("row_tr_depth", 1) if not segmentor else 0,
        swin_depths=tuple(cfg.backbone.get("depths", (2, 2, 6, 2)))
        if has_bb else ())


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


def adam_state_from_jax(state, mu: Dict, nu: Dict, count: int,
                        cfg) -> None:
    """Set the optimizer and scheduler of a train state
    (`engine/state.py::TrainState`) to an optax Adam state: ``mu`` and
    ``nu`` (numpy trees shaped like the flax params, of
    ``ScaleByAdamState``) become each parameter's ``exp_avg`` and
    ``exp_avg_sq``, ``count`` its ``step`` and the scheduler's position
    (optax's schedule counts the same updates).  Under ``optimizer.
    mu_dtype`` (`engine/optimizer.py::MuDtypeAdam`) ``exp_avg`` is stored
    in that dtype, as optax stores ``mu``.  Every parameter must be
    covered."""
    rules = rules_for(cfg)
    m_sd = params_from_jax(mu, {}, rules)
    v_sd = params_from_jax(nu, {}, rules)
    named = dict(state.model.named_parameters())
    missing = sorted(set(named) - set(m_sd)) + sorted(set(named) - set(v_sd))
    if missing:
        raise KeyError(f"the Adam state does not cover {missing[:8]}")
    mu_dtype = getattr(state.optimizer, "mu_dtype", None)
    for name, p in named.items():
        st = state.optimizer.state[p]
        st["step"] = torch.tensor(float(count))
        st["exp_avg"] = torch.zeros_like(p, dtype=mu_dtype or p.dtype).copy_(
            m_sd[name].view(p.shape))
        st["exp_avg_sq"] = torch.zeros_like(p).copy_(
            v_sd[name].view(p.shape))
    sched = state.scheduler
    sched.last_epoch = int(count)
    lrs = [base * f(int(count))
           for base, f in zip(sched.base_lrs, sched.lr_lambdas)]
    for group, lr in zip(state.optimizer.param_groups, lrs):
        group["lr"] = lr
    sched._last_lr = lrs
