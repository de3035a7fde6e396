"""The test suite's intra-op thread rule, set before anything imports torch.

Under pytest-xdist each worker gets an even share of the cores this process
may run on, at least one: torch (and OpenMP code in general) otherwise
starts a thread per core in every worker, and the workers' threads then
spin against each other.  Child processes (the tools' CLIs, gloo ranks)
inherit the value.  Outside xdist nothing changes.
"""

import os
import sys


def worker_threads(environ) -> int | None:
    """The intra-op thread count of an xdist worker with ``environ``, or
    None outside xdist."""
    workers = environ.get("PYTEST_XDIST_WORKER_COUNT")
    if not workers:
        return None
    return max(1, len(os.sched_getaffinity(0)) // int(workers))


_n = worker_threads(os.environ)
if _n is not None:
    os.environ["OMP_NUM_THREADS"] = str(_n)
    if "torch" in sys.modules:  # a plugin imported it first
        sys.modules["torch"].set_num_threads(_n)
