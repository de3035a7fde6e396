"""ColumnProposal2's two optional branches against the JAX package on the
CPU, at the tiny widths of the JAX package's own branch test
(`tests/test_models.py:137-170`: 64-wide tokens, 4 heads of 16, MLP 128),
with seeded weights carried across by ``tools/from_jax``:

- ``column_att``: the Conv_Pool_2d proposal generator, per-column tokens
  with per-proposal embeddings, the lane-correlator transformer and
  ``line_expand``;
- ``column_transformer_decoder``: learned lane queries cross-attending
  over 8x8 patch embeddings (flax's ``MultiHeadDotProductAttention``).

Bars: the whole net's outputs within rel-max 2e-3; through the 10-term
training loss on a real batch, the head's terms within rel 1e-5, its
parameter and input gradients within rel-max 2e-3 and its BatchNorm
statistics within rel-max 1e-5; the fused seg focal term, whose JAX float32
sum drifts from float64, is held to a float64 evaluation instead.  The loss keys and the head's output keys
are those of the head without a branch: training is unchanged.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import (configs, jax_apply, random_variables,
                                rel_max_err, state_dict_np, wire_data_root)

BRANCHES = ("column_att", "column_transformer_decoder")
# the widths of the JAX package's branch test
TR_TINY = {"heads.dim_token": 64, "heads.tr_heads": 4,
           "heads.tr_dim_head": 16, "heads.tr_mlp_dim": 128}
TERMS = ("proposal_loss", "ext_loss2", "cls_loss2", "cls_mean_loss2",
         "cls_smooth_loss2", "endp_loss", "orient_loss", "binary_seg_loss",
         "offset_loss", "semantic_seg_loss")


def branch_configs(branch, **over):
    cfgs = configs()
    for cfg in cfgs:
        cfg[branch] = True
        cfg.merge_from_dict({**TR_TINY, **over})
    return cfgs


def head_rules(cfg_t):
    from lanemapping_tpu_torch.tools.from_jax import rules_for
    return [r for r in rules_for(cfg_t) if r[0].startswith("heads.")]


def head_sd(params, batch_stats, rules):
    from lanemapping_tpu_torch.tools.from_jax import params_from_jax
    sd = params_from_jax({"heads": params}, {"heads": batch_stats}, rules)
    return {k[len("heads."):]: v for k, v in sd.items()}


@pytest.mark.parametrize("branch", BRANCHES)
def test_branch_net_matches_jax(branch):
    import lanemapping_tpu as lm
    import lanemapping_tpu_torch as lmt
    from lanemapping_tpu_torch.tools.from_jax import load_jax_weights

    cfg_j, cfg_t = branch_configs(branch)
    jm = lm.build_model(cfg_j)
    variables = random_variables(jm, (jnp.zeros((1, 192, 192, 3)),), 4)
    tm = lmt.build_model(cfg_t)
    assert getattr(tm.heads, branch)
    load_jax_weights(tm, variables["params"], variables["batch_stats"],
                     cfg_t)
    x = np.random.RandomState(5).rand(2, 192, 192, 3).astype(np.float32)
    want = jax_apply(jm, variables, jnp.asarray(x))
    with torch.no_grad():
        got = tm.eval()(torch.tensor(x))
    assert set(got) == set(want)
    for k in want:
        assert rel_max_err(got[k].numpy(), want[k]) < 2e-3, k


@pytest.fixture(scope="module")
def label_batch(tmp_path_factory):
    """A real batch of the tiny config as the port ships it (numpy)."""
    from lanemapping_tpu_torch.data.loader import build_dataloader
    from lanemapping_tpu_torch.data.synthetic import generate_dataset
    from lanemapping_tpu_torch.engine.runner import Runner

    root = str(tmp_path_factory.mktemp("laserlane"))
    generate_dataset(root, n_tiles=4, img=192, seed=3)
    _, cfg = configs()
    wire_data_root(cfg, root)
    batch = next(iter(build_dataloader(cfg.dataset.train, cfg)))
    runner = Runner(cfg, log_dir=str(tmp_path_factory.mktemp("logs")),
                    device="cpu")
    return {k: v.numpy() for k, v in runner._device_batch(batch).items()}


@pytest.mark.parametrize("branch", BRANCHES)
def test_branch_head_loss_and_gradients_match_jax(branch, label_batch):
    from lanemapping_tpu.models.head_losses import (column_proposal_loss as
                                                    jax_loss, head_hparams as
                                                    jax_hp)
    from lanemapping_tpu.registry import build_heads as jax_heads
    from lanemapping_tpu_torch.models.head_losses import (
        column_proposal_loss, head_hparams)
    from lanemapping_tpu_torch.registry import build_heads
    from test_torch_port_train_losses import f64_seg_focal

    cfg_j, cfg_t = branch_configs(branch)
    S = cfg_t.heads.row_size
    B = label_batch["prop_ext"].shape[0]
    rng = np.random.RandomState(6)
    ins = [rng.randn(B, S, S, 2), rng.randn(B, 2 * S, 2 * S, 8),
           rng.randn(B, 8 * S, 8 * S, 1)]
    ins = [a.astype(np.float32) for a in ins]
    # the encoder's maps the loss also reads, as fixed seeded logits
    enc = {"semantic_seg": 2 * rng.randn(B, 8 * S, 8 * S, 3),
           "endp_est": 2 * rng.randn(B, 8 * S, 8 * S, 1)}
    enc = {k: v.astype(np.float32) for k, v in enc.items()}

    jh = jax_heads(cfg_j)
    variables = random_variables(jh, [jnp.asarray(a) for a in ins], 7)
    hp_j = jax_hp(cfg_j)

    def jfn(params, xs):
        out, upd = jh.apply({"params": params,
                             "batch_stats": variables["batch_stats"]},
                            *xs, train=True, mutable=["batch_stats"])
        out.update({k: jnp.asarray(v) for k, v in enc.items()})
        res = jax_loss(out, {k: jnp.asarray(v)
                             for k, v in label_batch.items()}, hp_j)
        return res["loss"], (res["loss_stats"], upd["batch_stats"])

    jxs = [jnp.asarray(a) for a in ins]
    jkeys = sorted(jax.eval_shape(lambda p: jh.apply(
        {"params": p, "batch_stats": variables["batch_stats"]}, *jxs,
        train=True, mutable=["batch_stats"])[0], variables["params"]))
    (jl, (jstats, jbs)), (jgp, jgx) = jax.jit(jax.value_and_grad(
        jfn, argnums=(0, 1), has_aux=True))(variables["params"], jxs)
    jgp, jgx, jbs = jax.device_get((jgp, jgx, jbs))

    rules = head_rules(cfg_t)
    th = build_heads(cfg_t)
    missing, unexpected = th.load_state_dict(
        head_sd(variables["params"], variables["batch_stats"], rules),
        strict=False)
    assert not unexpected
    assert all(k.endswith("num_batches_tracked") for k in missing), missing
    xs = [torch.tensor(a).permute(0, 3, 1, 2).requires_grad_() for a in ins]
    out = th.train()(*xs)
    for k in ("orient", "endpoint"):
        if k in out:
            out[k] = out[k].permute(0, 2, 3, 1)
    out.update({k: torch.tensor(v) for k, v in enc.items()})
    res = column_proposal_loss(out, {k: torch.tensor(v)
                                     for k, v in label_batch.items()},
                               head_hparams(cfg_t))
    res["loss"].backward()

    plain = configs()[1]
    assert sorted(out) == sorted(set(jkeys) | set(enc)) == sorted(
        set(build_heads(plain).train()(*[x.detach() for x in xs]))
        | set(enc))
    assert set(res["loss_stats"]) == set(jstats) == set(TERMS)
    for k in TERMS:
        if k == "binary_seg_loss":
            continue
        assert float(res["loss_stats"][k].detach()) == pytest.approx(
            float(jstats[k]), rel=1e-5, abs=1e-7), k
    # the fused seg focal: the JAX package's float32 sum drifts up to
    # 1.2e-5 from float64 (PERF.md), so both packages are held to a
    # float64 evaluation of the port's logits, the port as its own loss
    # test holds it
    ext, coor = label_batch["prop_ext"], label_batch["prop_coor"]
    W = cfg_t.heads.prop_width + 2 * cfg_t.heads.prop_half_buff
    pos = np.where((coor >= W) | (coor < 0) | (ext == 0), 0.0, ext).sum(2) > 2
    want = f64_seg_focal(out["prop_seg_small"].detach().numpy(),
                         label_batch["prop_inst"], label_batch["prop_best"],
                         pos, S, W, cfg_t.heads.prop_width)
    got = float(res["loss_stats"]["binary_seg_loss"].detach())
    assert got == pytest.approx(want, rel=1e-6)
    assert float(jstats["binary_seg_loss"]) == pytest.approx(want, rel=2e-5)
    for x, g in zip(xs, jgx):
        g = np.asarray(g)
        if not np.any(g):  # x_endp: only endp_mode='endpoint' reads it
            assert x.grad is None
            continue
        assert rel_max_err(x.grad.permute(0, 2, 3, 1).numpy(), g) < 2e-3
    want = head_sd(jgp, {}, rules)
    got = {n: p.grad for n, p in th.named_parameters()}
    assert set(got) == set(want)
    for k, w in want.items():
        w = w.numpy()
        if not np.any(w):  # the endpoint branch: no gradient reaches it
            assert got[k] is None or not got[k].any(), k
            continue
        assert rel_max_err(got[k].numpy(), w) < 2e-3, k
    stats = state_dict_np(th)
    for k, w in head_sd({}, jbs, rules).items():
        assert rel_max_err(stats[k], w.numpy()) < 1e-5, k


@pytest.mark.parametrize("row_size,num_prop", [(24, 9), (24, 10), (20, 12)])
def test_column_att_needs_row_size_num_prop_times_power_of_two(row_size,
                                                               num_prop):
    from lanemapping_tpu.registry import build_heads as jax_heads
    from lanemapping_tpu_torch.registry import build_heads

    cfg_j, cfg_t = branch_configs("column_att", **{
        "heads.row_size": row_size, "heads.num_prop": num_prop})
    with pytest.raises(ValueError, match="num_prop"):
        build_heads(cfg_t)
    jh = jax_heads(cfg_j)
    with pytest.raises(ValueError, match="num_prop"):
        jax.eval_shape(lambda k: jh.init(
            k, jnp.zeros((1, row_size, row_size, 2)),
            jnp.zeros((1, 2 * row_size, 2 * row_size, 8)),
            jnp.zeros((1, 8 * row_size, 8 * row_size, 1))),
            jax.random.PRNGKey(0))


@pytest.mark.parametrize("branch", BRANCHES)
def test_flagship_branch_takes_the_jax_defaults(branch):
    """At the flagship config the head gets JAX's default token widths
    (`column_head.py:309-332` there: 1024, depth 1, 16 heads of 64, MLP
    2048) and the embeddings are drawn as the flax initializers draw
    them."""
    import os

    import lanemapping_tpu_torch as lmt
    from lanemapping_tpu_torch.models.nets import init_weights
    from lanemapping_tpu_torch.registry import build_heads
    from torch_port_helpers import REPO

    cfg = lmt.Config.fromfile(os.path.join(
        REPO, "configs", "Proj_polyline_fpn_vit_vertex_2.py"))
    cfg[branch] = True
    head = init_weights(build_heads(cfg), torch.Generator().manual_seed(0))
    S, P, C = 144, 72, 8
    sd = head.state_dict()
    if branch == "column_att":
        assert head.to_token[1].weight.shape == (1024, 2 * C * P)
        attn = head.tr_lane_correlator[0].layers[0][0].fn
        assert (attn.heads, attn.dim_head) == (16, 64)
        assert len(head.tr_lane_correlator[0].layers) == 1
        assert head.tr_lane_correlator[0].layers[0][1].fn.net[0] \
            .out_features == 2048
        assert head.line_expand[0].weight.shape == (C * S, 1024)
        emb = torch.stack([sd[f"emb_{i}"] for i in range(P)])
        assert abs(float(emb.std()) - 1.0) < 0.02
    else:
        assert sd["dec0_xattn.query.weight"].shape == (1024, 16, 64)
        assert sd["dec0_xattn.out.weight"].shape == (16, 64, 1024)
        assert "dec1_norm1.weight" not in sd
        assert head.dec0_mlp.net[0].out_features == 2048
        assert sd["img_pe"].shape == ((S // 8) ** 2, 1024)
        assert abs(float(sd["img_pe"].std()) - 0.02) < 0.001
        assert abs(float(sd["query_embed"].std()) - 1.0) < 0.02
