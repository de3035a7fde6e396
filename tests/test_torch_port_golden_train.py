"""The golden set's flagship training path T1 at full width (1152 px
tiles, 72 proposals x 144 rows, 324 tokens), batch 2
(`tests/torch_port_golden.py`, members written by
``tests/torch_port_make_golden.py --train``): three float32 steps of the
port's ``Runner.train_step`` on T0's first batch from a seeded
mid-training Adam state at the config's lr 2.1e-4, against the JAX
package in float64.

- Step 0's loss terms within rel 1e-5 of float64 (measured on an 8-core
  AVX512 CPU: <= 3.4e-7 at 4 and 8 intra-op threads, 4.5e-7 at 1 and 2;
  JAX float32's own: <= 1.7e-6).  The hold runs at ``HOLD_THREADS``; at
  1, 2, 4 and 8 threads (by hand: ``python tests/torch_port_golden.py
  holds t1 --threads 1 2 4 8``, ~1-3.5 min a count) the worst shares of
  the bars are gradient 0.59, change 0.65-0.67, BatchNorm statistics
  0.43-0.51, where at one thread before the CPU BatchNorm's and
  GroupNorm's repair (`models/norm.py`) they read 6.62, 2.33 and 1.99.
- Per group (a module's leaves), the step-0 gradient, the parameter
  change after three steps and every BatchNorm running statistic after
  them by d_port <= 1.5 d_jax32 + eps |v_ref| + rho |v_ref,group|: d the
  L2 distance from float64 (estimated per leaf from a subsample and a
  count sketch, each estimate held), d_jax32 JAX float32's, eps 1e-7,
  rho 1e-5 (a float32 reduction in another order: on the endpoint output
  layer JAX float32 sits 4e-8 of the gradient from float64, the port
  1.1e-6).
- The terms of steps 1 and 2, where each package's float32 trajectory
  has parted from float64's by 1e-5 to 2e-4 of a term, pooled: ratios
  d_port / d_jax (the denominator never below JAX's median relative
  distance times the term) with median within 1.5, largest within 10.
- The Adam draw without JAX (`torch_port_golden.draw_adam`) is
  ``mid_training_adam``'s bit for bit, and the stored float32 terms of
  step 0 are what the JAX package computes now (rel 1e-5).
"""

import jax
import numpy as np
import pytest

import torch_port_golden as G
import torch_port_make_golden as M
from torch_port_helpers import golden_threads  # noqa: F401


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    from lanemapping_tpu_torch.data import synthetic
    root = str(tmp_path_factory.mktemp("laserlane"))
    G.train_dataset(root, synthetic)
    return root


def test_draw_adam_is_mid_training_adam():
    from torch_port_helpers import mid_training_adam
    meta = G.load_train_meta()
    for name in G.CONFIGS:
        rec = meta["adam"][name]
        rng = np.random.RandomState(5)
        # gradients of the recorded shapes and RMS values
        grads = G.draw_adam([p for p, _ in rec["leaves"]],
                            [s for _, s in rec["leaves"]], rec["rms"], 7)[0]
        grads = jax.tree.map(lambda a: a * np.float32(rng.uniform(0.5, 2)),
                             grads)
        rms = G.grad_rms(grads)
        got = G.draw_adam([p for p, _ in rec["leaves"]],
                          [s for _, s in rec["leaves"]], rms, rec["seed"],
                          rec["count"])
        want = mid_training_adam(grads, rec["seed"], rec["count"])
        assert got[2] == want[2] == G.ADAM_COUNT
        got_l = jax.tree.leaves(got[:2])
        assert len(got_l) == 2 * len(rec["leaves"])
        for a, b in zip(got_l, jax.tree.leaves(want[:2])):
            assert a.dtype == b.dtype == np.float32
            assert np.array_equal(a, b)


def test_port_t1_meets_the_float64_bars(root, golden_threads):
    port = G.run_train("flagship", "cpu", "float32",
                       G.first_train_batch("flagship", root))
    golden = G.golden_pair("t1")
    plan = G.train_plan(port, G.load_train_meta()["paths"]["t1"])
    fig = G.hold_float32(port, golden, plan, "T1 on the CPU")
    # the bars are not empty: JAX float32 is off float64
    assert fig["term_rel_step0_jax"] > 1e-7
    assert fig["g"]["groups"] > 90 and fig["bn"]["groups"] == 36


def test_golden_t1_is_what_jax_computes_now(root):
    """T1's float32 terms of step 0 from JAX's differentiated function
    (its forward and loss) on the batch of the JAX package's loader."""
    import lanemapping_tpu as lm
    from lanemapping_tpu.data.loader import build_dataloader
    from torch_port_helpers import jax_device_batch
    cfg = M.train_config("flagship", root)
    batch = next(iter(build_dataloader(cfg.dataset.train, cfg)))
    variables = G.draw_variables(G.load_manifest("flagship"),
                                 G.WEIGHT_SEEDS["flagship"])
    terms = M.grads_fn(lm.build_model(cfg), cfg, "none", grad=False)(
        variables["params"], variables["batch_stats"],
        jax_device_batch(cfg, batch))
    np.testing.assert_allclose(G.term_vector(jax.device_get(terms)),
                               G.load_train_golden("t1")["terms_jax"][0],
                               rtol=G.REGEN_REL, atol=1e-9)
