"""engine/prefetch.MultiSegmentPrefetcher in the port: the contracts of the
JAX package's tests/test_prefetch.py:204-290 (the serially chained stream
at several widths, real concurrency, the error at the failing stream,
close, more streams than workers) held against the port's class, the
same streams through both packages' classes, and the queue registry."""

import sys
import threading
import time

import pytest

from processing_chain_tpu.engine import prefetch as jpf
from processing_chain_tpu_torch.engine import prefetch as tpf


def _msp_streams(lengths, base=0):
    """One factory per stream; stream i yields `lengths[i]` pairs
    (stream, position), so an ordering fault shows in the values."""
    def make(i, n):
        def factory():
            for k in range(n):
                yield (base + i, k)
        return factory
    return [make(i, n) for i, n in enumerate(lengths)]


CHAINS = {
    "w1": ([3, 0, 7, 1, 4, 0, 2], 1, 2),
    "w2": ([3, 0, 7, 1, 4, 0, 2], 2, 2),
    "w5": ([3, 0, 7, 1, 4, 0, 2], 5, 2),
    "more_streams_than_workers": ([2] * 9, 3, 1),
    "empty": ([], 2, 2),
}


@pytest.mark.parametrize("case", sorted(CHAINS))
def test_multi_prefetcher_matches_serial_chain(case):
    """The consumer sees exactly the serially chained streams, equal to
    what the JAX package's class yields for the same factories."""
    lengths, workers, depth = CHAINS[case]
    want = [(i, k) for i, n in enumerate(lengths) for k in range(n)]
    with tpf.MultiSegmentPrefetcher(_msp_streams(lengths), workers=workers,
                                    depth=depth) as pre:
        got = list(pre)
    with jpf.MultiSegmentPrefetcher(_msp_streams(lengths), workers=workers,
                                    depth=depth) as pre:
        assert list(pre) == want
    assert got == want


def test_multi_prefetcher_decodes_concurrently():
    """With workers=2 the second stream starts before the first finishes:
    stream 0 blocks until stream 1 has produced, which serial chaining
    never would, so completion proves real concurrency."""
    s1_started = threading.Event()

    def s0():
        yield 0
        assert s1_started.wait(timeout=5.0)
        yield 1

    def s1():
        s1_started.set()
        yield 10

    with tpf.MultiSegmentPrefetcher([s0, s1], workers=2, depth=2) as pre:
        assert list(pre) == [0, 1, 10]


def test_multi_prefetcher_error_surfaces_at_failing_stream():
    def bad():
        yield (1, 0)
        raise ValueError("decode failed mid-stream")

    factories = _msp_streams([2]) + [bad] + _msp_streams([2], base=9)
    pre = tpf.MultiSegmentPrefetcher(factories, workers=2, depth=2)
    it = iter(pre)
    assert [next(it), next(it)] == [(0, 0), (0, 1)]  # stream 0 intact
    assert next(it) == (1, 0)
    with pytest.raises(ValueError, match="decode failed mid-stream"):
        list(it)
    pre.close()
    assert not any(t.is_alive() for t in pre._threads)


def test_multi_prefetcher_close_stops_workers():
    produced = []

    def slow():
        for i in range(10_000):
            produced.append(i)
            yield i

    pre = tpf.MultiSegmentPrefetcher([slow, slow], workers=2, depth=2)
    next(iter(pre))
    pre.close()
    n = len(produced)
    time.sleep(0.05)
    assert len(produced) == n  # all workers stopped pulling
    assert not any(t.is_alive() for t in pre._threads)


def test_multi_prefetcher_registers_its_queues():
    """Each stream's queue is a live "decode" queue while the prefetcher
    runs, as in the JAX package, so the resource monitor samples them."""
    gate = threading.Event()

    def held():
        yield 0
        gate.wait(timeout=5.0)

    pre = tpf.MultiSegmentPrefetcher([held, held, held], workers=2, depth=2)
    try:
        assert all(tpf._QUEUE_REGISTRY[id(q)][0] == "decode" for q in pre._queues)
        assert tpf.live_queue_depths()["decode"]["queues"] >= 3
    finally:
        gate.set()
        pre.close()


def test_multi_prefetcher_claims_each_stream_once_under_contention():
    """Many more workers than cores, with a short switch interval: every
    stream is claimed by exactly one worker and the chain stays serial."""
    lengths = [k % 4 for k in range(64)]
    calls = [0] * len(lengths)

    def make(i, n):
        def factory():
            calls[i] += 1
            for k in range(n):
                yield (i, k)
        return factory

    got = []
    pre = tpf.MultiSegmentPrefetcher([make(i, n) for i, n in enumerate(lengths)],
                                     workers=16, depth=1)
    consumer = threading.Thread(target=lambda: got.extend(pre), daemon=True)
    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        consumer.start()
        consumer.join(timeout=60)
    finally:
        sys.setswitchinterval(saved)
        pre.close()
    assert not consumer.is_alive()
    assert got == [(i, k) for i, n in enumerate(lengths) for k in range(n)]
    assert calls == [1] * len(lengths)
    assert not any(t.is_alive() for t in pre._threads)
