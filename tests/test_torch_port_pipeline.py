"""The port's batch loop (`engine/pipeline.py::pipelined`), on plain Python
stages: every batch once, in order, the device stage on the calling
thread and the host stage on the workers (inline at 0), at most
``2 * workers`` batches in flight, ``max_batches`` read from the source
and no more, and a host stage's exception raised to the caller."""

import threading
import time

import pytest

from lanemapping_tpu_torch.engine.pipeline import pipelined

N = 10


class Stages:
    """Stages that record their threads and the batches in flight; the
    host stage of an earlier batch takes longer, so the workers finish out
    of order."""

    def __init__(self):
        self.lock = threading.Lock()
        self.pulled = self.started = self.finished = self.most_in_flight = 0
        self.device_threads, self.host_threads = set(), set()

    def source(self):
        for b in range(N):
            self.pulled += 1
            yield b

    def device(self, b):
        self.device_threads.add(threading.get_ident())
        with self.lock:
            self.started += 1
            self.most_in_flight = max(self.most_in_flight,
                                      self.started - self.finished)
        return 10 * b

    def host(self, out, b):
        self.host_threads.add(threading.get_ident())
        time.sleep(0.002 * (N - b))
        with self.lock:
            self.finished += 1
        return out + b


@pytest.mark.parametrize("max_batches", [None, 4])
@pytest.mark.parametrize("workers", [0, 1, 3])
def test_pipelined_runs_each_batch_once_in_order(workers, max_batches):
    s = Stages()
    got = pipelined(s.source(), s.device, s.host, workers, max_batches)
    n = N if max_batches is None else max_batches
    assert got == [11 * b for b in range(n)]
    assert s.pulled == s.started == s.finished == n
    assert s.device_threads == {threading.get_ident()}
    if workers == 0:
        assert s.host_threads == {threading.get_ident()}
        assert s.most_in_flight == 1
    else:
        assert threading.get_ident() not in s.host_threads
        assert len(s.host_threads) <= workers
        assert 1 < s.most_in_flight <= 2 * workers


@pytest.mark.parametrize("workers", [0, 3])
def test_pipelined_raises_a_host_error_to_the_caller(workers):
    def host(out, b):
        if b == 2:
            raise ValueError("batch 2")
        return out

    with pytest.raises(ValueError, match="batch 2"):
        pipelined(range(N), lambda b: b, host, workers)
