"""The Swin backbone (`models/swin.py`) against the JAX package on the CPU,
with seeded weights carried across by ``tools/from_jax``:

- the JAX test's Swin (embed 32, depths (2, 2), heads (2, 4), window 4,
  a 64x64 input): each stage within rel-max 1e-5;
- one shifted block (window 4, shift 2, on 8x8 tokens) within rel-max
  1e-5, and unlike the same block unshifted;
- the window partition round trip, and the partition equal to JAX's.

The JAX Swin runs eagerly here: its shift mask converts a traced array to
numpy (`swin.py:114` there), so a shifted block cannot be traced by
``jax.jit`` or ``jax.eval_shape``.  The port builds the mask with torch
ops on the input's device.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch
from torch_port_helpers import random_variables, rel_max_err

SMALL = dict(patch_size=4, embed_dim=32, depths=(2, 2), num_heads=(2, 4),
             window_size=4, out_indices=(0, 1))


def carry(variables, prefix_rules):
    from lanemapping_tpu_torch.tools.from_jax import params_from_jax
    return params_from_jax(variables["params"], {}, prefix_rules)


def strip(rules, t, j):
    return [(a[len(t):], b[len(j):], f) for a, b, f in rules
            if a.startswith(t)]


def test_swin_stages_match_jax():
    from lanemapping_tpu.models.swin import SwinTransformer as JSwin
    from lanemapping_tpu_torch.registry import BACKBONE
    from lanemapping_tpu_torch.tools.from_jax import swin_rules

    jm = JSwin(**SMALL)
    x = np.random.RandomState(0).randn(2, 64, 64, 3).astype(np.float32)
    variables = random_variables(jm, (jnp.asarray(x),), 2, eager=True)
    assert not variables["batch_stats"]
    # a relative-position table of the scale flax draws it at
    rng = np.random.RandomState(3)
    for i, depth in enumerate(SMALL["depths"]):
        for d in range(depth):
            a = variables["params"][f"stage{i}_block{d}"]["attn"]
            a["rel_bias"] = (0.02 * rng.randn(*a["rel_bias"].shape)).astype(
                np.float32)
    tm = BACKBONE.get("SwinTransformer")(**{
        k: list(v) if isinstance(v, tuple) else v for k, v in SMALL.items()})
    missing, unexpected = tm.load_state_dict(carry(variables, strip(
        swin_rules(SMALL["depths"]), "backbone.", "backbone/")), strict=False)
    assert not missing and not unexpected
    want = jax.device_get(jm.apply(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert [tuple(g.shape) for g in got] == [(2, 32, 16, 16), (2, 64, 8, 8)]
    for g, w in zip(got, want):
        assert rel_max_err(g.permute(0, 2, 3, 1).numpy(), w) < 1e-5


def test_shifted_block_matches_jax():
    from lanemapping_tpu.models.swin import SwinBlock as JBlock
    from lanemapping_tpu_torch.models.swin import SwinBlock
    from lanemapping_tpu_torch.tools.from_jax import swin_rules

    x = np.random.RandomState(1).randn(2, 8, 8, 16).astype(np.float32)
    jb = JBlock(16, 2, 4, shift=2)
    variables = random_variables(jb, (jnp.asarray(x),), 4, init_kw={},
                                 eager=True)
    variables["params"]["attn"]["rel_bias"] *= 0.2
    rules = strip(swin_rules((1,), prefix="b"), "b.stage0_block0.",
                  "b/stage0_block0/")
    outs = {}
    for shift in (2, 0):
        tb = SwinBlock(16, 2, 4, shift=shift)
        missing, unexpected = tb.load_state_dict(carry(variables, rules),
                                                 strict=False)
        assert not missing and not unexpected
        with torch.no_grad():
            outs[shift] = tb(torch.from_numpy(x)).numpy()
    want = np.asarray(jb.apply(variables, jnp.asarray(x)))
    assert rel_max_err(outs[2], want) < 1e-5
    assert rel_max_err(outs[0], want) > 1e-3


def test_window_partition_round_trip_and_jax_order():
    from lanemapping_tpu.models.swin import window_partition as jax_partition
    from lanemapping_tpu_torch.models.swin import (window_partition,
                                                   window_reverse)

    x = np.random.RandomState(1).randn(2, 8, 12, 5).astype(np.float32)
    w = window_partition(torch.from_numpy(x), 4)
    assert w.shape == (2 * 2 * 3, 16, 5)
    np.testing.assert_array_equal(w.numpy(),
                                  np.asarray(jax_partition(jnp.asarray(x),
                                                           4)))
    np.testing.assert_array_equal(window_reverse(w, 4, 8, 12).numpy(), x)
