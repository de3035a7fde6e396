"""The plain reference agrees with the program on the CPU at a tiny size:
each loop's check, run in float32, reads round-off."""

import pytest

from conftest import run_tiny, tiny_cell


def test_serving_reference_agrees_with_the_program():
    rec = run_tiny(tiny_cell("flagship.serve_las", "float32"), seconds=2.0)
    got = {n: v for n, v, _ in rec.checks}
    assert rec.notes["tiles_compared"] == 2
    assert got["input_gap"] < 1e-6
    assert got["head_gap"] < 1e-5
    assert got["decode_mismatches"] == 0 and got["json_mismatches"] == 0
    assert rec.correct and rec.failed == 0 and rec.units > 0


@pytest.mark.parametrize("name", ["flagship.train", "lidar.train"])
def test_training_reference_agrees_with_the_program(name):
    rec = run_tiny(tiny_cell(name, "float32"), seconds=1.0)
    got = {**{n: v for n, v, _ in rec.checks},
           **rec.notes.get("readings", {})}
    # float32 round-off through three steps, thread counts apart (oneDNN's
    # convolutions); bf16 reads 5e-3 and more
    assert got["loss_gap"] < 1e-4
    assert got["grad_gap"] < 1e-4
    # the first step's head outputs, the whole batch
    assert got["head1_gap"] < 1e-4
    # Adam's first steps move a leaf by about lr * sign(g): a leaf whose
    # gradient sits near zero flips on round-off
    assert got["change_gap"] < 1e-2
    assert rec.correct and rec.units > 0
