"""krust_tpu's tests/test_flat.py, run against the port through krust_tpu's
call forms (see tests/torch_reference_suite.py and
tests/torch_reference_forms.py)."""

import threading

import numpy as np
import pytest

from krust_tpu_torch.io import packer as port_packer
from krust_tpu_torch.models import engines as port_engines
from torch_reference_suite import load

_WIDTHS = ("flat_batch_widths (krust_tpu/io/packer.py:317), the byte-per-base packer's "
           "metadata twin, as the function under test: removed from the port for good")
_FEED = ("_prefetch_staged (krust_tpu/models/engines.py:436), a private feed generator; "
         "the port's feed is the context manager _Feed (krust_tpu_torch/models/engines.py)")

STATED = {
    "TestFlatBatchWidths": _WIDTHS,
    "TestPrefetchFeed::test_error_propagates": _FEED,
    "TestPrefetchFeed::test_early_abandon_no_deadlock": _FEED,
    "TestPrefetchFeed::test_stage_runs_on_worker": _FEED,
}

#: each STATED test -> the port's test of its counterpart behaviour
BESIDE = {
    "TestFlatBatchWidths": "test_port_flat_scan_and_batch_count_match_flat_batches",
    "TestPrefetchFeed::test_error_propagates": "TestPortFeed::test_error_propagates",
    "TestPrefetchFeed::test_early_abandon_no_deadlock": "TestPortFeed::test_early_exit_stops_thread",
    "TestPrefetchFeed::test_stage_runs_on_worker": "TestPortFeed::test_stage_runs_on_worker",
}

globals().update(load("test_flat", STATED))


@pytest.mark.parametrize("n,k,ninv,qual", [(0, 5, 0, False), (3, 5, 0, False),
                                           (2000, 5, 20, False), (5000, 21, 100, False),
                                           (777, 31, 3, False), (1000, 5, 100, False),
                                           (3000, 7, 40, True)])
def test_port_flat_scan_and_batch_count_match_flat_batches(n, k, ninv, qual):
    """The port's metadata without a pack: ``flat_scan`` makes the
    flat-or-dense decision of ``flat_batches`` (None past 1/32 invalid
    bases) and ``batch_count`` its number of batches; the batches'
    ``invpos``, each padded to a power of two, hold every invalid
    position of the stream."""
    rng = np.random.default_rng(n + k)
    codes = rng.integers(0, 4, n, dtype=np.uint8)
    q, thr = None, None
    if qual:
        q, thr = np.full(n, 70, np.uint8), 53
        q[rng.choice(n, size=ninv, replace=False)] = 35
    elif ninv and n:
        codes[rng.choice(n, size=min(ninv, n), replace=False)] = 4
    w, rows = 128, 4
    flat = port_packer.flat_batches(codes, q, k, thr, w, rows)
    scan = port_packer.flat_scan(codes, q, thr, n // 32)
    assert (flat is None) == (scan is None) == (ninv > n // 32)
    if flat is None:
        return
    batches = list(flat)
    assert len(batches) == port_packer.batch_count(n, k, w, rows)
    seen = set()
    for i, b in enumerate(batches):  # batch i starts at base i * rows * w
        width = b.invpos.shape[0]
        assert width >= 8 and width & (width - 1) == 0 and width >= b.n_invalid
        seen.update((i * rows * w + b.invpos[: b.n_invalid]).tolist())
    assert seen == set(port_packer.invalid_positions(codes, q, thr).tolist())


class TestPortFeed:
    """The port's double-buffered feed, ``_Feed``: errors reach the
    consumer, an early exit stops the worker, stages run on the worker."""

    def test_error_propagates(self):
        def gen():
            yield 1
            raise RuntimeError("reader exploded")

        with port_engines._Feed(gen(), lambda x: x * 2, depth=2) as feed:
            it = iter(feed)
            assert next(it) == 2
            with pytest.raises(RuntimeError, match="reader exploded"):
                list(it)

    def test_early_exit_stops_thread(self):
        feed = port_engines._Feed(iter(range(1000)), lambda x: x, depth=1)
        with feed:
            assert next(iter(feed)) == 0
        assert feed._thread is not None and not feed._thread.is_alive()

    def test_stage_runs_on_worker(self):
        main = threading.current_thread().name
        seen = []

        def stage(x):
            seen.append(threading.current_thread().name)
            return x

        with port_engines._Feed(iter([1, 2]), stage, depth=2) as feed:
            assert list(feed) == [1, 2]
        assert seen and all(name != main for name in seen)
