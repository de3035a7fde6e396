"""The four configs of the slice through the port's Runner against the JAX
package's on the CPU, at tiny widths (`torch_port_helpers.ZOO_TINY`):
RowRef (Detector1stage + RowSharNotReducRef), Seg (legacy Detector +
PostProjector + ViT with shared MLP + GridSeg), FPN Seg (Segmentor) and the
MLP-Mixer ablation (Detector1stage + MixSegNet + ColumnProposal2).

For each, with the same weights (``random_variables`` ->
``load_jax_weights``) and a synthetic LaserLane dataset:

- ``validate``: the metrics of the JAX Runner's ``_validate_grid`` /
  ``_validate_seg`` / ``_validate_lanes`` (run on the JAX forward), equal;
- the export driver with ``write_view``: the same files, identical lane
  JSONs (MixSeg: columns to 1e-3 px) and identical overlay PNGs, and for
  the Segmentor equal metrics;
- one train step: loss terms within rel 1e-5, gradients within rel-max
  2e-3, BatchNorm running statistics within rel-max 1e-5 (the PR-4 bars);
- the port's ``tools/infer.py --device cpu``.

The weight seeds keep every decision of the forward clear of the float32
differences between the packages: the row head's argmaxes and gate, and
for the others the decoded maps of the two packages are asserted equal
before the metrics are compared.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from torch_port_helpers import (ZOO_COMMON, ZOO_CONFIGS, ZOO_TINY,
                                assert_clear_of_thresholds,
                                assert_same_records, jax_device_batch,
                                port_batch_numpy, port_runner, rel_max_err,
                                state_dict_np, wire_data_root, zoo_models)

NAMES = ["rowref", "gridseg", "fpnseg", "mixseg"]
# weight seeds whose decisions sit clear of float32 rounding (asserted)
SEEDS = {"rowref": 2, "gridseg": 0, "fpnseg": 0, "mixseg": 0}
MARGIN = 1e-4
NAMES_6 = [f"{190000 + i:06d}_{i:04d}" for i in range(6)]
EXPORTS = {"rowref": (".json", "_overlay.png", "_grid.png"),
           "gridseg": (".json", "_overlay.png", "_grid.png"),
           "fpnseg": ("_segmentor.png", "_seg_skeleton.png"),
           "mixseg": (".json", "_overlay.png")}


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    """6 tiles: train 4 (2 batches of 2), valid = test = the other 2."""
    from lanemapping_tpu_torch.data.synthetic import generate_dataset

    root = str(tmp_path_factory.mktemp("laserlane"))
    generate_dataset(root, n_tiles=6, img=192, seed=5, splits={
        "train": NAMES_6[:4], "valid": NAMES_6[4:], "test": NAMES_6[4:]})
    return root


def setup(name, root, log_dir):
    jm, variables, _, cfg_j, cfg_t = zoo_models(name, SEEDS[name])
    for cfg in (cfg_j, cfg_t):
        wire_data_root(cfg, root)
        cfg.log_dir = str(log_dir)
    cfg_j.endp_decode = "exact_topk"  # the port's top-k is exact
    return jm, variables, cfg_j, cfg_t, port_runner(cfg_t, variables,
                                                    log_dir)


def jax_stub(jm, variables, cfg_j):
    """The JAX Runner's validate and export methods on one CPU device,
    around a forward of ``variables``."""
    from lanemapping_tpu.decode.lane_decode import (decode_lanes,
                                                    host_decode_view)
    from lanemapping_tpu.engine.runner import Runner

    stub = object.__new__(Runner)
    stub.cfg, stub.state, stub.use_lidar = cfg_j, variables, False
    stub._log = lambda *a, **k: None
    stub._eval_input = lambda batch: jnp.asarray(
        np.asarray(batch["proj"], np.float32))
    stub._eval_step = jax.jit(lambda v, x: jm.apply(v, x, train=False))
    stub._eval_decode = jax.jit(lambda v, x: host_decode_view(decode_lanes(
        jm.apply(v, x, train=False), cfg_j)))
    return stub


def loaders(cfg, split="val"):
    """A fresh eval loader of the port and of the JAX package."""
    from lanemapping_tpu.data.loader import build_dataloader as jax_loader
    from lanemapping_tpu_torch.data.loader import build_dataloader
    return (build_dataloader(cfg[1].dataset[split], cfg[1], is_train=False),
            jax_loader(cfg[0].dataset[split], cfg[0], is_train=False))


def assert_same_decisions(name, runner, stub, cfg_j, batch):
    """The decoded maps the host reads agree between the packages, with
    the row head's and the column head's decisions asserted clear of the
    threshold margin."""
    out = jax.device_get(stub._eval_step(stub.state,
                                         stub._eval_input(batch)))
    if name == "rowref":
        from lanemapping_tpu.decode.row_decode import decode_row_lanes
        for stage in ("", "2"):
            p = np.sort(out["cls" + stage], axis=-1)
            assert (p[..., -1] - p[..., -2]).min() > MARGIN, stage
            e = out["ext" + stage]
            assert np.abs(e[..., 0] - e[..., 1]).min() > MARGIN, stage
        gate = out["ext"][..., 0].mean(-1)
        assert np.abs(gate - cfg_j.heads.thr_ext).min() > MARGIN
        want = jax.device_get(decode_row_lanes(out, cfg_j.number_lanes))
        got = runner._host(runner._eval_grid(batch))
    elif name == "gridseg":
        want = {"conf": out["conf"] > cfg_j.conf_thr,
                "cls": out["cls"].argmax(-1)}
        g = runner._host(runner._eval_grid(batch))
        got = {"conf": g["conf"] > cfg_j.conf_thr, "cls": g["cls"].argmax(-1)}
        assert rel_max_err(g["conf"], out["conf"]) < 2e-3
    elif name == "fpnseg":
        from lanemapping_tpu.decode.seg_infer import segmentor_infer
        want = jax.device_get(segmentor_infer(out, seg_thre=cfg_j.seg_thre,
                                              n_lanes=cfg_j.number_lanes))
        got = runner._host(runner._eval_seg(batch))
    else:
        from lanemapping_tpu.decode.lane_decode import decode_lanes
        assert_clear_of_thresholds(
            jax.device_get(decode_lanes(out, cfg_j)), cfg_j, margin=MARGIN,
            clamped_columns=True)
        return
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("name", NAMES)
def test_validate_and_export_match_jax(name, data_root, tmp_path):
    jm, variables, cfg_j, cfg_t, runner = setup(name, data_root,
                                                tmp_path / "log")
    stub = jax_stub(jm, variables, cfg_j)
    cfgs = (cfg_j, cfg_t)
    assert_same_decisions(name, runner, stub, cfg_j,
                          next(iter(loaders(cfgs)[0])))

    metrics = runner.validate()
    port_loader, jloader = loaders(cfgs)
    head = runner.head_type
    if name == "fpnseg":
        want = stub._validate_seg(jloader, None)
    elif head in ("RowSharNotReducRef", "GridSeg"):
        want = stub._validate_grid(jloader, None, head)
    else:
        want = stub._validate_lanes(jloader, None)
    assert set(metrics) == set(want)
    for k in want:
        assert metrics[k] == pytest.approx(want[k], abs=1e-12), k
    assert os.path.isdir(tmp_path / "log" / "ckpt" / "best")

    dirs = {p: str(tmp_path / p) for p in ("port", "jax")}
    port_loader, jloader = loaders(cfgs, "test")
    if name == "fpnseg":
        got = runner.infer_segmentor_and_export(port_loader, dirs["port"],
                                                write_view=True)
        want = stub.infer_segmentor_and_export(jloader, dirs["jax"],
                                               write_view=True)
        assert got == pytest.approx(want, abs=1e-12)
    elif head in ("RowSharNotReducRef", "GridSeg"):
        runner.infer_grid_and_export(port_loader, dirs["port"],
                                     write_view=True)
        stub.infer_grid_and_export(jloader, dirs["jax"], write_view=True)
    else:
        runner.infer_and_export(port_loader, dirs["port"], write_view=True)
        stub.infer_and_export(jloader, dirs["jax"], write_view=True)
    files = sorted(os.listdir(dirs["jax"]))
    assert sorted(os.listdir(dirs["port"])) == files and files
    for f in files:
        got, want = (os.path.join(d, f) for d in (dirs["port"],
                                                  dirs["jax"]))
        if f.endswith(".json"):
            g, w = json.load(open(got)), json.load(open(want))
            if name == "mixseg":
                assert_same_records([g], [w])
            else:
                assert g == w, f
        else:
            np.testing.assert_array_equal(np.asarray(Image.open(got)),
                                          np.asarray(Image.open(want)),
                                          err_msg=f)
    assert files == sorted(n[:11] + s for n in NAMES_6[4:]
                           for s in EXPORTS[name])


def jax_loss(cfg_j):
    """The JAX Runner's loss dispatch (`runner.py:70-90` there)."""
    from lanemapping_tpu.models.head_losses import (column_proposal_loss,
                                                    head_hparams,
                                                    segmentor_loss)
    from lanemapping_tpu.models.row_head import grid_seg_loss, row_shar_loss

    if cfg_j.net.type == "Segmentor":
        return segmentor_loss
    h = cfg_j.heads
    if h.type == "RowSharNotReducRef":
        return lambda o, b: row_shar_loss(
            o, b, n_lanes=cfg_j.number_lanes, row_size=h.row_size,
            lambda_cls=h.get("lambda_cls", 1.0))
    if h.type == "GridSeg":
        return lambda o, b: grid_seg_loss(o, b, num_classes=h.num_classes,
                                          dataset_type=cfg_j.dataset_type)
    hp = head_hparams(cfg_j)
    return lambda o, b: column_proposal_loss(o, b, hp)


@pytest.mark.parametrize("name", NAMES)
def test_one_train_step_matches_jax(name, data_root, tmp_path):
    """One float32 step: loss terms, the gradients of every parameter
    outside the image encoder (whose float32 gradient is ill-conditioned
    at random weights in both packages, PR 4) and of the Segmentor's
    output convolutions, and every BatchNorm's running statistics."""
    from lanemapping_tpu.engine.state import model_input
    from lanemapping_tpu_torch.data.loader import build_dataloader
    from lanemapping_tpu_torch.tools.from_jax import params_from_jax, rules_for

    jm, variables, cfg_j, cfg_t, runner = setup(name, data_root,
                                                tmp_path / "log")
    batch = next(iter(build_dataloader(cfg_t.dataset.train, cfg_t)))
    db = runner._device_batch(batch)
    jdb = jax_device_batch(cfg_j, batch)
    assert set(port_batch_numpy(db)) == set(jdb)
    loss_fn = jax_loss(cfg_j)

    @jax.jit
    def grads(params, batch_stats, b):
        def inner(p):
            out, upd = jm.apply({"params": p, "batch_stats": batch_stats},
                                model_input(b), train=True,
                                mutable=["batch_stats"])
            res = loss_fn(out, b)
            return res["loss"], (res["loss_stats"], upd["batch_stats"])
        return jax.value_and_grad(inner, has_aux=True)(params)

    (jl, (jstats, jbs)), jg = jax.device_get(grads(
        variables["params"], variables["batch_stats"], jdb))
    stats = runner.train_step(runner.state, db)
    assert stats["skipped_nan"] == 0.0
    assert set(stats) == set(jstats) | {"loss", "skipped_nan"}
    for k in jstats:
        np.testing.assert_allclose(float(stats[k]), float(jstats[k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    np.testing.assert_allclose(float(stats["loss"]), float(jl), rtol=1e-5)

    rules = rules_for(cfg_t)
    want_g = params_from_jax(jg, {}, rules)
    got_g = {n: p.grad for n, p in runner.model.named_parameters()}
    assert set(got_g) == set(want_g)
    held = [k for k in want_g if not k.startswith("pcencoder.")
            or k.split(".")[2].startswith("output_layer")]
    assert held
    for k in held:
        assert rel_max_err(got_g[k].numpy(), want_g[k].numpy()) < 2e-3, k
    got = state_dict_np(runner.model)
    want_bs = params_from_jax({}, jbs, rules)
    assert want_bs
    for k, w in want_bs.items():
        assert rel_max_err(got[k], w.numpy()) < 1e-5, k


@pytest.mark.parametrize("name", NAMES)
def test_infer_cli_runs_on_cpu(name, data_root, tmp_path):
    """``tools/infer.py --device cpu`` on a state_dict: the Runner's
    metrics, and the export driver's files."""
    from lanemapping_tpu_torch.engine.runner import Runner
    from lanemapping_tpu_torch.tools import infer
    from torch_port_helpers import REPO

    _, cfg_t = zoo_models_cfg(name, data_root, tmp_path)
    runner = Runner(cfg_t, log_dir=str(tmp_path / "ref"), device="cpu")
    ckpt = str(tmp_path / "w.pth")
    torch.save(runner.model.state_dict(), ckpt)
    want = runner.validate()
    over = {**ZOO_COMMON, **ZOO_TINY[name], "log_dir": str(tmp_path / "cli"),
            "seed": 1}
    for split in ("train", "val", "test"):
        over[f"dataset.{split}.data_root"] = data_root
    args = [os.path.join(REPO, "configs", ZOO_CONFIGS[name])]
    args += [f"{k}={v!r}" if isinstance(v, str) else f"{k}={v}"
             for k, v in over.items()]
    out_dir = str(tmp_path / "lanes")
    res = infer.main(args + ["--device", "cpu", "--ckpt", ckpt,
                             "--save-lanes", out_dir, "--view"])
    assert res["metrics"] == pytest.approx(want, abs=1e-12)
    files = os.listdir(out_dir)
    if name == "fpnseg":
        assert set(res["segmentor_infer"]) >= {"coor_conf_f1",
                                               "semantic_conf_f1"}
        assert len([f for f in files if f.endswith("_segmentor.png")]) == 2
    else:
        assert len([f for f in files if f.endswith(".json")]) == 2
        assert len([f for f in files if f.endswith("_overlay.png")]) == 2
    assert infer.parse_args(args[:1]).device == "cuda"


def zoo_models_cfg(name, root, tmp_path):
    from torch_port_helpers import zoo_configs
    cfgs = zoo_configs(name)
    for cfg in cfgs:
        wire_data_root(cfg, root)
        cfg.log_dir = str(tmp_path / "log")
    return cfgs


@pytest.mark.parametrize("over", [
    {"heads": {"_delete_": True, "type": "PixelSeg"}},
    {"net.type": "Detector"},
])
def test_runner_refuses_unported_pairs(over, tmp_path):
    """Nets and heads outside the shipped configs stay refused: PixelSeg
    (the JAX Runner has no loss for it) and the legacy Detector with
    ColumnProposal2 (which needs the encoder's fine maps)."""
    from lanemapping_tpu_torch.engine.runner import Runner
    from torch_port_helpers import TINY, configs

    _, cfg = configs(TINY)
    cfg.merge_from_dict(over)
    with pytest.raises(NotImplementedError, match="not ported"):
        Runner(cfg, log_dir=str(tmp_path), device="cpu")
