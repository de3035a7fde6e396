"""The port's benchmark (`lanemapping_tpu_torch/tools/bench.py`) against
the JAX package and the root `bench.py`, on the CPU at the tiny configs.

- ``count_model_flops``: the convolution FLOPs of a forward equal the JAX
  jaxpr's ``conv_general_dilated`` count within rel 1e-6 (the jaxpr also
  holds the column head's endpoint branch on a 1x1 zero input, 1728 FLOPs
  at batch 2, which the port's eval forward skips); the matmul FLOPs stay
  at or below the jaxpr's ``dot_general`` count (the JAX package computes
  its resizes as dense operator products, the port does not); ``meta``
  counts what CPU tensors count.
- The serving pass's ``[batch]`` digest equals the JAX ``model.apply`` +
  ``decode_lanes`` digest within rel 1e-4, float32, with the decode's
  decisions clear of their thresholds.
- The ``--train`` batch is byte for byte the root script's recipe
  (`bench.py:100-129`, transcribed below).
"""

import ast
import json
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import (REPO, TINY, TINY_LIDAR,
                                assert_clear_of_thresholds, configs,
                                lidar_example, random_variables, tiny_models)

NEW_MODULES = ("bench", "profile_train", "train_mfu_sweep", "config_smoke")


def _subjaxprs(params):
    for v in params.values():
        for x in (v if isinstance(v, (tuple, list)) else (v,)):
            if isinstance(x, jax.extend.core.ClosedJaxpr):
                yield x.jaxpr
            elif isinstance(x, jax.extend.core.Jaxpr):
                yield x


def jaxpr_flops(jaxpr):
    """(conv, dot) FLOPs of a jaxpr from the shapes of its
    ``conv_general_dilated`` and ``dot_general`` equations: 2 x output
    elements x the reduced size, nested jaxprs included (a scan's body
    times its length; a while loop is refused)."""
    conv = dots = 0
    for e in jaxpr.eqns:
        name = e.primitive.name
        assert name != "while", "a while loop's trip count is unknown"
        out = int(np.prod(e.outvars[0].aval.shape)) if e.outvars else 0
        if name == "conv_general_dilated":
            rhs = e.invars[1].aval.shape
            spec = e.params["dimension_numbers"].rhs_spec
            conv += 2 * out * int(np.prod([rhs[i] for i in spec[1:]]))
        elif name == "dot_general":
            (lc, _), _ = e.params["dimension_numbers"]
            lhs = e.invars[0].aval.shape
            dots += 2 * out * int(np.prod([lhs[i] for i in lc]))
        mult = e.params["length"] if name == "scan" else 1
        for sub in _subjaxprs(e.params):
            c, d = jaxpr_flops(sub)
            conv, dots = conv + mult * c, dots + mult * d
    return conv, dots


@pytest.mark.parametrize("path", [TINY, TINY_LIDAR],
                         ids=["tiny_test", "tiny_test_lidar"])
def test_count_model_flops_matches_the_jax_jaxpr(path):
    import lanemapping_tpu as lm
    from lanemapping_tpu_torch.tools.bench import count_model_flops

    cfg_j, cfg_t = configs(path)
    jmodel = lm.build_model(cfg_j)
    lidar = bool(cfg_j.get("use_lidar", False))
    example = lidar_example(cfg_j.max_points) if lidar \
        else jnp.zeros((1, 192, 192, 3))
    variables = random_variables(jmodel, (example,), 0)
    x = {"points": jnp.zeros((2, cfg_j.max_points, 4)),
         "points_mask": jnp.ones((2, cfg_j.max_points), bool)} if lidar \
        else jnp.zeros((2, 192, 192, 3))
    jx = jax.make_jaxpr(lambda v, x: jmodel.apply(v, x, train=False))(
        variables, x)
    conv_j, dots_j = jaxpr_flops(jx.jaxpr)

    meta = count_model_flops(cfg_t, 2, train=False)
    cpu = count_model_flops(cfg_t, 2, train=False, device="cpu")
    assert meta["by_op"] == cpu["by_op"]
    assert abs(meta["conv"] - conv_j) / conv_j < 1e-6, (meta, conv_j)
    assert 0 < meta["matmul"] <= dots_j, (meta, dots_j)
    assert meta["total"] == meta["conv"] + meta["matmul"]


@pytest.mark.parametrize("path", [TINY, TINY_LIDAR],
                         ids=["tiny_test", "tiny_test_lidar"])
def test_train_count_is_forward_loss_and_backward(path):
    """The training count runs the loss and the backward on ``meta`` (no
    3x fallback), equals the CPU count, and sits between 2x and 3x the
    forward (the first layer's input gradient is not computed)."""
    from lanemapping_tpu_torch.config.config import Config
    from lanemapping_tpu_torch.tools.bench import count_model_flops

    cfg = Config.fromfile(path)
    train = count_model_flops(cfg, 2, train=True)
    assert train["flops_method"].startswith("FlopCounterMode on meta")
    assert "aten.convolution_backward" in train["by_op"]
    assert train["by_op"] == count_model_flops(cfg, 2, train=True,
                                               device="cpu")["by_op"]
    fwd = count_model_flops(cfg, 2, train=False)["total"]
    assert 2 * fwd < train["total"] <= 3 * fwd + 3 * 1728


def test_train_count_falls_back_to_three_forwards(monkeypatch):
    """A loss that cannot run on ``meta`` leaves 3x the train-mode
    forward, and ``flops_method`` says so."""
    from lanemapping_tpu_torch.config.config import Config
    from lanemapping_tpu_torch.models import head_losses
    from lanemapping_tpu_torch.tools.bench import count_model_flops

    cfg = Config.fromfile(TINY)

    def refuse(*a, **k):
        raise NotImplementedError("no meta kernel")

    monkeypatch.setattr(head_losses, "column_proposal_loss", refuse)
    got = count_model_flops(cfg, 2, train=True)
    assert got["flops_method"].startswith("3x the train-mode forward")
    assert "no meta kernel" in got["flops_method"]
    # the train-mode forward also runs the head's 1x1 endpoint branch
    assert got["total"] == 3 * (count_model_flops(cfg, 2, train=False)[
        "total"] + 1728)


def test_count_ignores_remat():
    """Model FLOPs: a remat policy recomputes, the count does not move."""
    from lanemapping_tpu_torch.config.config import Config
    from lanemapping_tpu_torch.tools.bench import count_model_flops

    cfg = Config.fromfile(TINY)
    plain = count_model_flops(cfg, 2, train=True)["total"]
    for policy in ("full", "dots"):
        cfg.remat, cfg.remat_policy = True, policy
        assert count_model_flops(cfg, 2, train=True)["total"] == plain
    assert cfg.remat  # the caller's config is left as it was


# seed 3's decoded values on this input sit clear of every decision
# threshold (asserted; integer columns are the decode's clamp to the window
# width, equal in both), so float32 rounding cannot flip a proposal or a
# column argmax between the packages
DIGEST_SEED = 3


def test_serving_digest_matches_jax():
    from lanemapping_tpu.decode.lane_decode import decode_lanes
    from lanemapping_tpu_torch.tools.bench import make_pass

    jmodel, variables, tmodel, cfg_j, cfg_t = tiny_models(seed=DIGEST_SEED)
    x = np.random.RandomState(0).rand(2, 192, 192, 3).astype(np.float32)

    @jax.jit
    def jax_pass(v, p):
        return decode_lanes(jmodel.apply(v, p, train=False), cfg_j)

    dec = jax.device_get(jax_pass(variables, x))
    assert_clear_of_thresholds(dec, cfg_j, clamped_columns=True)
    want = (dec["cls_offset"].mean(axis=(1, 2))
            + dec["prop_conf"].mean(axis=(1, 2))
            + dec["endp_coords"].mean(axis=(1, 2)))
    with torch.inference_mode():
        got = make_pass(tmodel, cfg_t, torch.float32)(
            torch.from_numpy(x)).numpy()
    assert got.shape == (2,) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-4)


def jax_recipe(cfg, B, fused, use_lidar, n_pts):
    """`bench.py:100-129` of the root script, as written there."""
    img = cfg.list_img_size_xy[0]
    S, P = cfg.heads.row_size, cfg.heads.num_prop
    W = cfg.heads.prop_width + 2 * cfg.heads.prop_half_buff
    rng = np.random.RandomState(0)
    if use_lidar:
        lo = np.array(cfg.lidar_point_cloud_range[:3] + [800.0], np.float32)
        hi = np.array(cfg.lidar_point_cloud_range[3:] + [33000.0],
                      np.float32)
        pts = lo + rng.rand(B, n_pts, 4).astype(np.float32) * (hi - lo)
        inp = {"points": pts, "points_mask": np.ones((B, n_pts), bool)}
    else:
        inp = {"proj": rng.rand(B, img, img, 3).astype(jnp.bfloat16)}
    batch = {
        **inp,
        "prop_ext": rng.randint(0, 3, (B, P, S)).astype(np.uint8),
        "prop_coor": rng.uniform(-1, W, (B, P, S)).astype(np.float32),
        "prop_offset": rng.randn(B, P, S, W).astype(np.float32),
        "prop_offset_mask": rng.randint(0, 2, (B, P, S, W)).astype(
            np.float32),
        "lc_orient": rng.randint(0, 11, (B, S, S)).astype(np.uint8),
        "semantic_label_raw": rng.randint(0, 3, (B, img, img)).astype(
            np.uint8),
        "endp_map": np.where(rng.rand(B, img, img) > 0.999,
                             rng.rand(B, img, img), 0).astype(jnp.bfloat16),
    }
    if fused:
        batch["prop_inst"] = np.where(
            rng.rand(B, img, img) < 0.01,
            rng.randint(0, 12, (B, img, img)), 255).astype(np.uint8)
        batch["prop_best"] = rng.randint(0, 12, (B, P)).astype(np.uint8)
    else:
        batch["prop_bi_seg"] = rng.randint(
            0, 2, (B, P, img, 8 * W)).astype(np.uint8)
    return batch


@pytest.mark.parametrize("path,fused", [(TINY, True), (TINY, False),
                                        (TINY_LIDAR, True)],
                         ids=["fused", "unfused", "lidar"])
def test_train_batch_is_the_root_recipe_byte_for_byte(path, fused):
    from lanemapping_tpu_torch.tools import bench

    n_pts = 4096
    cfg_j, cfg_t = configs(path)
    cfg_t.fused_seg_focal = fused
    lidar = bool(cfg_t.get("use_lidar", False))
    if lidar:
        cfg_t.max_points = n_pts
    want = jax_recipe(cfg_j, 3, fused, lidar, n_pts)
    got = bench.train_batch(cfg_t, 3, np.random.RandomState(0))
    assert list(got) == list(want)
    for k, w in want.items():
        g = got[k]
        assert tuple(g.shape) == w.shape, k
        assert g.element_size() == w.dtype.itemsize, k
        as_bytes = g.view(torch.uint8) if g.dtype != torch.bool else g
        assert as_bytes.numpy().tobytes() == w.tobytes(), k


def test_no_tpu_constant_in_the_new_modules():
    for name in NEW_MODULES:
        path = os.path.join(REPO, "lanemapping_tpu_torch", "tools",
                            name + ".py")
        with open(path) as f:
            src = f.read()
        for token in ("197e12", "819", "v5e", "E2E_BENCH"):
            assert token not in src, (name, token)


def test_record_keys_are_the_root_scripts_less_the_tpu_ones():
    """The serving and training records carry the root script's keys but
    its TPU projection and v5e share, and add ``train_mfu``,
    ``flops_method`` and the card."""
    with open(os.path.join(REPO, "bench.py")) as f:
        tree = ast.parse(f.read())
    keys = {}
    for fn in tree.body:
        if isinstance(fn, ast.FunctionDef) and fn.name in ("main",
                                                           "main_train"):
            dicts = [n for n in ast.walk(fn) if isinstance(n, ast.Dict)
                     and any(isinstance(k, ast.Constant) and k.value ==
                             "metric" for k in n.keys)]
            keys[fn.name] = {k.value for d in dicts for k in d.keys
                             if isinstance(k, ast.Constant)}
    from lanemapping_tpu_torch.tools import bench

    tpu = {"projected_8chip_vs_baseline", "train_mfu_vs_v5e_bf16_peak"}
    serve = bench.main(["--config", TINY, "--batch", "1", "--iters", "1",
                        "--warmup", "0", "--device", "cpu"])
    assert keys["main"] - tpu <= set(serve)
    assert not tpu & set(serve) and "mfu" in serve
    train = bench.main(["--train", "--config", TINY, "--batch", "2",
                        "--iters", "1", "--no-remat", "--device", "cpu"])
    assert keys["main_train"] - tpu <= set(train)
    assert {"train_mfu", "flops_method", "device"} <= set(train)
    assert train["train_mfu"] is None and train["device"] == "cpu"
    assert np.isfinite(train["losses"]).all()


def test_analyze_only_reports_flops_after_one_untimed_step():
    from lanemapping_tpu_torch.tools import bench

    rec = bench.main(["--train", "--analyze-only", "--config", TINY_LIDAR,
                      "--lidar-points", "2048", "--batch", "2", "--device",
                      "cpu"])
    assert rec["metric"] == "train_step_analysis"
    assert {"batch", "img", "remat", "remat_policy", "step_flops",
            "hbm_highwater_gb"} <= set(rec)
    assert rec["remat"] and rec["remat_policy"] == "full"
    assert rec["step_flops"] == bench.count_model_flops(
        bench.train_config(bench.parse_args([
            "--train", "--config", TINY_LIDAR, "--lidar-points", "2048"])),
        2, train=True)["total"]
    assert "value" not in rec


def test_bench_fails_without_a_card_and_on_an_unknown_card(monkeypatch):
    out = subprocess.run([sys.executable, "-m",
                          "lanemapping_tpu_torch.tools.bench", "--train",
                          "--config", TINY], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode != 0
    assert "CUDA" in out.stderr and not re.search(r"^\{", out.stdout, re.M)
    from lanemapping_tpu_torch.tools import bench
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda *a: "NVIDIA Unknown Card")
    with pytest.raises(KeyError, match="no published peak"):
        bench.card_peak(torch.device("cuda"))
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda *a: "NVIDIA H100 80GB HBM3")
    assert bench.card_peak(torch.device("cuda"))["bf16_flops_per_s"] == \
        989e12
    assert bench.card_peak(torch.device("cpu")) is None


def test_e2e_json_quotes_a_stream_bench_record(tmp_path):
    from lanemapping_tpu_torch.tools import bench

    rec = tmp_path / "stream_bench.json"
    rec.write_text(json.dumps({"value": 34.5, "km_lane_per_hour": 27611.7}))
    out = bench.main(["--config", TINY, "--batch", "1", "--iters", "1",
                      "--warmup", "0", "--device", "cpu", "--e2e-json",
                      str(rec)])
    assert out["e2e_tiles_per_sec_per_chip"] == 34.5
    assert out["km_lane_per_hour"] == 27611.7
