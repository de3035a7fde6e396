"""The suite's intra-op thread rule (the repository's root ``conftest.py``):
an xdist worker runs at its share of the usable cores, at least one, and
its child processes inherit the count; outside xdist nothing changes."""

import os
import subprocess
import sys

import pytest
import torch

ROOT_CONFTEST = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "conftest.py")
CORES = len(os.sched_getaffinity(0))


@pytest.fixture
def rule(request):
    """``worker_threads`` of the root conftest, as pytest loaded it."""
    for plugin in request.config.pluginmanager.get_plugins():
        if getattr(plugin, "__file__", None) == ROOT_CONFTEST:
            return plugin.worker_threads
    pytest.fail("the root conftest.py is not loaded")


@pytest.mark.parametrize("workers, want", [
    (None, None), ("1", CORES), ("6", max(1, CORES // 6)),
    (str(CORES + 1), 1)])
def test_the_rule_shares_the_cores_among_the_workers(rule, workers, want):
    environ = {} if workers is None \
        else {"PYTEST_XDIST_WORKER_COUNT": workers}
    assert rule(environ) == want


def test_a_worker_and_its_children_run_at_the_rule(rule):
    n = rule(os.environ)
    if n is not None:
        assert os.environ["OMP_NUM_THREADS"] == str(n)
        assert torch.get_num_threads() == n
    out = subprocess.run(
        [sys.executable, "-c", "import os, torch; print(os.environ.get("
         "'OMP_NUM_THREADS'), torch.get_num_threads())"],
        capture_output=True, text=True, check=True).stdout.split()
    assert out[0] == os.environ.get("OMP_NUM_THREADS", "None")
    if n is not None:
        assert int(out[1]) == n
