"""On the card (skipped elsewhere): the tiny cells run their loops with
the program's CUDA kernels on the timed path and pass their checks.

    python -m pytest -m cuda lanebench/tests/test_lanebench_card.py
"""

import time

import pytest

from conftest import tiny_cell

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("name", ["flagship.serve_las", "flagship.train",
                                  "lidar.train"])
def test_tiny_cell_on_the_card(card, name):
    from lanebench import core
    cell = tiny_cell(name)
    rec = core.Run(cell, 2.0, False)
    rec.device_kind = "card"
    core.loop(cell).run(cell, rec, 3000000023, 2.0, card,
                        time.perf_counter())
    assert rec.correct, rec.checks
    assert rec.units > 0 and rec.memory_peak_bytes > 0
    if name != "flagship.train":
        assert sum(rec.launches.values()) > 0
