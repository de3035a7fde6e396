"""The port's Runner on 2 gloo ranks against its own single-process run on
the CPU (`tests/torch_port_dist_workers.py::runner_checks`: both runs
spawned at once, at ``configs/tiny_test.py``, global batch 4, from the same
seeded weights).

- a plain run of 2 steps and ``validate(max_batches=2)``: the step-0 loss
  within rel 1e-6, then the bars of the root `tools/multihost_test.py`
  (every logged loss within rel 1e-3, the parameter digest within rel
  1e-5, every validation metric within abs 5e-2); every rank logs the
  same global loss terms, and after the run every rank's parameters and
  buffers are bit-identical to the other's;
- the NaN guard: a non-finite input on rank 1 only makes both ranks skip
  the update (parameters, buffers and optimizer state as before, the
  step counted);
- dropout 0.3 in the correlator, and ``remat=True`` (the trunk stages
  checkpointed), one step each: 2 ranks equal 1 at the same bars; with
  remat the running statistics move once per step (in each run, the
  buffers within rel-max 1e-5 of the plain run's after its first step);
"""

import json
import os

import numpy as np
import pytest
import torch
from torch_port_dist_workers import join_all, runner_checks, spawn

from lanemapping_tpu_torch.tools.multihost_test import (BARS, compare,
                                                        make_dataset)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The Runner checks on 1 and on 2 ranks, spawned at once."""
    work = str(tmp_path_factory.mktemp("runner"))
    root = make_dataset(os.path.join(work, "tiles"))
    join_all(spawn(runner_checks, 1, root, work, None),
             spawn(runner_checks, 2, root, work, None))

    def load(world, rank):
        with open(os.path.join(work, f"runner_{world}rank_{rank}.json")) as f:
            return json.load(f)
    return {"one": load(1, 0), "two": [load(2, r) for r in range(2)]}


def as_run(sub):
    """A ``multihost_test.compare`` record of a sub-run."""
    return {"losses": [s["loss"] for s in sub["records"]],
            "param_digest": sub["digests"][0]["param_digest"],
            "rank_sha256": [d["sha256"] for d in sub["digests"]],
            "val": sub.get("val", {})}


@pytest.mark.parametrize("what", ["plain", "dropout", "remat"])
def test_two_ranks_equal_one_process(runs, what):
    one, two = runs["one"][what], [r[what] for r in runs["two"]]
    assert two[0]["records"] == two[1]["records"]  # the global terms
    a, b = one["records"][0]["loss"], two[0]["records"][0]["loss"]
    assert abs(a - b) <= 1e-6 * abs(a), (a, b)
    assert all(r["skipped_nan"] == 0.0 for r in two[0]["records"])
    cmp = compare(as_run(one), as_run(two[0]))
    assert cmp["ranks_bit_identical"], cmp
    assert cmp["max_rel_loss_diff"] < BARS["loss_rel"], cmp
    assert cmp["param_digest_rel_diff"] < BARS["digest_rel"], cmp
    assert all(v < BARS["metric_abs"]
               for v in cmp["val_metric_abs_diff"].values()), cmp
    if what == "plain":
        assert {"coor_f1", "endp_f1", "composite"} <= set(one["val"])
        assert two[0]["val"] == two[1]["val"]  # merged over the ranks


def test_remat_moves_the_running_statistics_once_per_step(runs):
    """With the trunk checkpointed the buffers end where the plain run's
    do, in one process and on each of 2 ranks: the recompute in the
    backward pass (which repeats the global-statistics collectives) does
    not move them a second time."""
    for res in [runs["one"]] + runs["two"]:
        plain = res["plain"]["buffers_step1"]
        remat = res["remat"]["buffers_step1"]
        assert plain.keys() == remat.keys() and plain
        worst = max(float(np.abs(np.subtract(remat[k], v)).max()
                          / max(1e-3, np.abs(v).max()))
                    for k, v in plain.items())
        assert worst < 1e-5


def test_nan_on_one_rank_skips_the_update_on_both(runs):
    for res in runs["two"]:
        nan = res["nan"]
        assert nan["skipped"] == 1.0 and not nan["loss_finite"]
        assert nan["step"] == 2
        assert nan["state_kept"] and nan["optimizer_kept"]
