"""The golden set's training batch T0 at full width (1152 px tiles,
clouds of 2^19 points), batch 2: the loader's first two batches of the
seeded 4-tile LaserLane set (`torch_port_golden.train_dataset`) of each
config, as ``Runner._device_batch`` ships them, with the proposal-GT
cache off, filling and serving.

- The port's: the same tiles in the same order, every key's bytes equal
  to the JAX package's (sha256; on the card the float keys may instead
  meet their float64 moments within rel 1e-6).
- The stored digests are what the JAX package's loader and
  ``_device_batch`` give now.
- The generator's float64 convolution (``tap_conv``) is XLA's, value and
  gradient, within 1e-12.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_port_golden as G
import torch_port_make_golden as M


@pytest.fixture(scope="module")
def t0(tmp_path_factory):
    from lanemapping_tpu_torch.data import synthetic
    root = str(tmp_path_factory.mktemp("laserlane"))
    G.train_dataset(root, synthetic)
    return root, G.run_t0("cpu", root)


def test_port_t0_meets_the_golden_batches(t0):
    _, run = t0
    fig = G.hold_t0(run, G.load_train_meta(), "T0 on the CPU",
                    exact_floats=True)
    assert set(fig) == set(G.CONFIGS)
    assert "proj" in fig["flagship"] and "points" in fig["lidar"]


def test_golden_t0_is_what_jax_computes_now(t0):
    from lanemapping_tpu.data.loader import build_dataloader
    from torch_port_helpers import jax_device_batch
    root, _ = t0
    meta = G.load_train_meta()
    for name in G.CONFIGS:
        cfg = M.train_config(name, root)
        batches = list(build_dataloader(cfg.dataset.train, cfg))
        assert [b["image_name"] for b in batches] == meta["t0"][name]["names"]
        for b, want in zip(batches, meta["t0"][name]["batches"]):
            G.check_batch(G.batch_errors(jax_device_batch(cfg, b), want),
                          f"T0 {name} from JAX", exact_floats=True)


@pytest.mark.parametrize("case", [
    ((2, 9, 11, 3), (3, 3, 3, 4), (2, 2), "SAME", None, (1, 1)),
    ((2, 9, 11, 3), (3, 3, 3, 4), (2, 1), [(1, 2), (0, 1)], (2, 2), (1, 2)),
    ((2, 16, 16, 3), (7, 7, 3, 5), (2, 2), [(3, 3), (3, 3)], None, None),
    ((2, 13, 3), (1, 3, 4), (1,), "VALID", None, None)])
def test_tap_conv_is_xla_in_float64(case):
    xs, ws, strides, pad, lhs_d, rhs_d = case
    n = len(xs) - 2
    dn = ("NHWC", "HWIO", "NHWC") if n == 2 else ("NWC", "WIO", "NWC")
    rng = np.random.RandomState(0)
    with M.float64_jax():
        x, w = jnp.asarray(rng.randn(*xs)), jnp.asarray(rng.randn(*ws))

        def f(conv):
            return lambda a, b: jnp.sum(jnp.sin(conv(a, b, strides, pad, lhs_d,
                                                     rhs_d, dn)))
        for got, want in ((M.tap_conv(x, w, strides, pad, lhs_d, rhs_d, dn),
                           M._LAX_CONV(x, w, strides, pad, lhs_d, rhs_d,
                                       dn)),
                          *zip(jax.grad(f(M.tap_conv), (0, 1))(x, w),
                               jax.grad(f(M._LAX_CONV), (0, 1))(x, w))):
            assert got.dtype == want.dtype == jnp.float64
            assert got.shape == want.shape
            np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                       rtol=1e-12, atol=1e-12)
