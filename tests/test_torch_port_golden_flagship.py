"""The golden set's flagship paths at full width (1152 px tiles, 72
proposals x 144 rows, 324 tokens): P1, ``LaneMapper.map_arrays`` in
float32, and P2, the bf16 stream's device program, both on the same two
seeded tiles (``tests/torch_port_golden.py``).

- The manifest's weights are ``random_variables``' bit for bit, drawn
  without JAX.
- The stored set is what the JAX package computes now: floats within
  rel-max 1e-5 (XLA's CPU results may differ in the last bits across
  CPUs), lane structure identical, columns within 1e-3 px.
- The port on the CPU meets the golden bars: head outputs within rel-max
  2e-3 (measured here: <= 4.0e-5), the moments of the subsampled maps
  within rel 1e-4, the same lanes with columns within 1e-2 px (measured:
  3.4e-3) at all but 1e-3 of the vertices (the host tracker's near-ties;
  none here), endpoints equal, semantic_map differing at <= 1e-4 of its
  pixels; in bf16 each output's distance from the float32 golden d_port <=
  1.5 d_jax + 1e-2, where d_jax is JAX's own bf16 distance (measured:
  d_port 1.9e-2 to 4.1e-2, d_jax 2.3e-2 to 6.0e-2).
"""

import jax.numpy as jnp
import numpy as np

import torch_port_golden as G
import torch_port_make_golden as M
from torch_port_helpers import golden_threads, random_variables  # noqa: F401


def test_draw_variables_equals_random_variables_flagship():
    """Bit for bit, and the manifest is the JAX package's tree now."""
    import lanemapping_tpu as lm
    manifest = G.load_manifest("flagship")
    assert manifest == M.manifest("flagship")
    cfg = lm.Config.fromfile(f"{G.REPO}/{G.CONFIGS['flagship']}")
    want = random_variables(lm.build_model(cfg),
                            (jnp.zeros((1, G.IMG, G.IMG, 3)),),
                            G.WEIGHT_SEEDS["flagship"])
    got = G.draw_variables(manifest, G.WEIGHT_SEEDS["flagship"])
    got_l, want_l = G.flat_leaves(got), G.flat_leaves(want)
    assert [p for p, _ in got_l] == [p for p, _ in want_l]
    assert len(got_l) == len(manifest["leaves"]) > 200
    for (path, a), (_, b) in zip(got_l, want_l):
        assert a.dtype == b.dtype == np.float32, path
        assert np.array_equal(a, b), path


def test_golden_tiles_are_the_generators():
    """The JAX package's generators and the port's copies give the stored
    tiles (the card rebuilds them from the port's)."""
    from lanemapping_tpu.data import synthetic as syn_j
    from lanemapping_tpu_torch.data import synthetic as syn_t
    want = G.load_meta()["inputs"]["tiles"]
    G.check_digest(G.golden_tiles(syn_j), want, "JAX generators")
    G.check_digest(G.golden_tiles(syn_t), want, "port generators")


def test_golden_p1_is_what_jax_computes_now():
    """(The seeds' screen, recorded in golden.json, is not run again.)"""
    rec, _ = M.p1(M.inputs()["tiles"], screened=False)
    G.check_regen(G.regen_errors(rec, G.load_golden("p1")), "P1")
    for margin, unstable in G.load_meta()["paths"]["p1"]["screen"]:
        assert margin > M.MARGIN and unstable == 0


def test_golden_p2_is_what_jax_computes_now():
    rec, _ = M.p2(M.inputs()["tiles"])
    G.check_regen(G.regen_errors(rec, G.load_golden("p2")), "P2")


def test_port_p1_meets_the_golden_bars(golden_threads):
    run = G.run_p1("cpu")
    fig = G.hold_p1(run, G.load_golden("p1"), "P1 on the CPU")
    assert fig["lanes"]["lanes"] == fig["lanes"]["lanes_golden"]
    assert min(fig["lanes"]["lanes"]) > 0


def test_port_p2_bf16_meets_the_bf16_rule(golden_threads):
    run = G.run_p2("cpu")
    assert run["dtype"] == "torch.bfloat16"
    fig = G.hold_p2(run, G.load_golden("p2"), G.load_golden("p1"),
                    "P2 on the CPU")
    # the rule is not empty: bf16 is far from float32 in both packages
    assert min(d["d_jax"] for d in fig["bf16"].values()) > 1e-3
    assert min(fig["lanes"]) > 0
