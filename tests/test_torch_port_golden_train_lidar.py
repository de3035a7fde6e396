"""The golden set's LiDAR training path at full width (2^19 points a cloud,
a 576 x 576 x 10 grid, 144 rows), batch 2: T3, the step of
``configs/Proj_polyline_lidarconv_vit_vertex_2.py`` as it ships (the JAX
step casts the weights to bf16 and flax promotes them against the float32
points, so it computes float32 on bf16-rounded weights; the port's
``Runner`` does the same, the z-fold grid from K1z on a card and from its
plain version here), three steps from a seeded mid-training Adam state at
the config's lr, against the JAX package in float64 on the same
bf16-rounded weights (`tests/torch_port_golden.py`).

- The terms of step 0 within rel 1e-5 of float64 (measured here: <=
  3.0e-7; JAX's own 1.3e-6), the later terms pooled and the BatchNorm
  statistics (2,288 floats) per layer as T1 in
  `test_torch_port_golden_train.py` (worst share of the bar here: 0.37).
- The step-0 gradient and the parameter change by the pooled rule (as
  T2): the gradient comes back through the bf16 cast of the weights,
  rounded to bf16 in every run, so a module's distance counts the few
  elements whose rounding flips; the ratios d_port / d_jax over the
  modules (denominators never below JAX's median relative distance) with
  median within 1.5 and 90th percentile within 5.0 (measured here:
  gradient 0.95 and 1.91).
- The z-fold grid of each tile by the P4 bars: the same occupancy, row
  sums within rel 1e-6, sampled cells within abs 1e-5.
- The stored terms of step 0 and grids are what the JAX package computes
  now.
"""

import jax
import numpy as np
import pytest

import torch_port_golden as G
import torch_port_make_golden as M


@pytest.fixture(scope="module")
def batches(tmp_path_factory):
    from lanemapping_tpu_torch.data import synthetic
    from lanemapping_tpu_torch.data.loader import build_dataloader
    root = str(tmp_path_factory.mktemp("laserlane"))
    G.train_dataset(root, synthetic)
    cfg = G.port_train_config("lidar", root)
    return root, list(build_dataloader(cfg.dataset.train, cfg))


def test_port_t3_meets_the_float64_bars(batches):
    _, host = batches
    port = G.run_train("lidar", "cpu", "bfloat16", host[0], grids=True)
    golden = G.golden_pair("t3")
    plan = G.train_plan(port, G.load_train_meta()["paths"]["t3"])
    fig = G.hold_float32(port, golden, plan, "T3 on the CPU",
                         pooled=True)
    G.hold_t3_grids(port, golden["jax"], "T3 on the CPU")
    assert fig["term_rel_step0_jax"] > 1e-8
    assert fig["g"]["n"] > 100 and fig["d"]["n"] > 100
    assert fig["bn"]["groups"] == 18


def test_golden_t3_is_what_jax_computes_now(batches):
    import lanemapping_tpu as lm
    from lanemapping_tpu.data.loader import build_dataloader
    from torch_port_helpers import jax_device_batch
    root, _ = batches
    cfg = M.train_config("lidar", root)
    db = jax_device_batch(cfg, next(iter(build_dataloader(cfg.dataset.train,
                                                          cfg))))
    variables = G.draw_variables(G.load_manifest("lidar"),
                                 G.WEIGHT_SEEDS["lidar"])
    terms = M.grads_fn(lm.build_model(cfg), cfg, "bf16", grad=False)(
        variables["params"], variables["batch_stats"], db)
    golden = G.load_train_golden("t3")
    np.testing.assert_allclose(G.term_vector(jax.device_get(terms)),
                               golden["terms_jax"][0], rtol=G.REGEN_REL,
                               atol=1e-9)
    rec = M.lidar_grids(cfg, db)
    G.check_regen(G.regen_errors(rec, {k: golden[k] for k in rec}), "T3")
