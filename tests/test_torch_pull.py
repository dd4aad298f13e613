"""The chunked table pull (``ops/table._pull_table``) on CPU tables.

A CPU table's own memory takes the pinned ring's place, and the same
chunked, threaded decode-and-widen runs that a card's pull runs. The pull
must equal the one-shot decode byte for byte: ``keys_to_codes`` of the
keys, the counts widened to u64, and K6's plain histogram of the counts.
The chunk and a thread's least share are patched down so that the
multi-chunk, multi-thread cases stay small.
"""

import os
import sys
import threading

import numpy as np
import pytest
import torch

from krust_tpu_torch.ops import table as table_mod
from krust_tpu_torch.ops.histogram import count_histogram_plain
from krust_tpu_torch.ops.keys import codes_to_keys, key_dtype, keys_to_codes, sentinel
from krust_tpu_torch.utils import tracing

CHUNK = 64
PART = 8
#: entries pulled: none, one, one chunk, one chunk and one, several chunks
#: with a ragged tail
SIZES = {"empty": 0, "one": 1, "chunk": CHUNK, "chunk_plus_one": CHUNK + 1,
         "ragged": 5 * CHUNK + 19}


@pytest.fixture
def small_chunks(monkeypatch):
    monkeypatch.setattr(table_mod, "PULL_CHUNK_ENTRIES", CHUNK)
    monkeypatch.setattr(table_mod, "PULL_PART_ENTRIES", PART)


def _table(k: int, n: int, seed: int = 0):
    """A finished table of n distinct codes ascending, its counts, and a
    tail of sentinel padding past n: (keys, int32 counts) tensors."""
    rng = np.random.default_rng(seed + 1000 * k + n)
    top = (1 << (2 * k)) - 1  # the all-ones code, the sentinel's
    codes = np.unique(rng.integers(0, top - 1, size=n + 8, dtype=np.uint64))[: max(n - 1, 0)]
    if n:  # the largest code below the sentinel's: bit 63 set at k = 32
        codes = np.append(codes, np.uint64(top - 1))
    assert codes.size == n
    counts = rng.integers(1, 5000, size=n, dtype=np.int32)
    if n:
        counts[0] = np.int32(2**31 - 1)  # the largest count a lifetime holds
    pad = 13
    keys = np.concatenate([codes_to_keys(codes, k),
                           np.full(pad, sentinel(key_dtype(k)),
                                   dtype=np.int32 if k <= 16 else np.int64)])
    cnt = np.concatenate([counts, np.zeros(pad, np.int32)])
    return torch.from_numpy(keys), torch.from_numpy(cnt)


class _PullSpans:
    def __init__(self):
        self.fields = []

    def __call__(self, kind, name, fields):
        if kind == "span" and name == "pull_table":
            self.fields.append(fields)

    def __enter__(self):
        tracing.add_collector(self)
        return self

    def __exit__(self, *exc):
        tracing.remove_collector(self)


@pytest.mark.parametrize("size", sorted(SIZES))
@pytest.mark.parametrize("k", [16, 21, 31, 32])
def test_the_chunked_pull_equals_the_one_shot_decode(small_chunks, k, size):
    n = SIZES[size]
    t_keys, t_cnt = _table(k, n)
    if k == 32 and n > 2:
        assert (keys_to_codes(t_keys[:n].numpy(), k) >> np.uint64(63)).any()
    before = table_mod._copy_decode.chunks
    with _PullSpans() as spans:
        pulled = table_mod._pull_table(t_keys, t_cnt, n, k)
    codes, counts = pulled
    want_codes = keys_to_codes(t_keys[:n].numpy(), k)
    want_counts = t_cnt[:n].numpy().astype(np.uint64)
    assert codes.dtype == counts.dtype == np.uint64
    assert codes.tobytes() == want_codes.tobytes()
    assert counts.tobytes() == want_counts.tobytes()
    # the result owns its bytes: no view of the table's memory
    assert codes.flags.owndata and counts.flags.owndata and codes.flags.writeable
    want_hist = count_histogram_plain(t_cnt[:n])
    np.testing.assert_array_equal(pulled.histogram.values, want_hist.values)
    np.testing.assert_array_equal(pulled.histogram.freqs, want_hist.freqs)
    chunks = -(-n // CHUNK)
    assert table_mod._copy_decode.chunks - before == chunks
    threads = max(1, min(len(os.sched_getaffinity(0)), -(-min(n, CHUNK) // PART)))
    key_bytes = 4 if k <= 16 else 8
    assert spans.fields == [{"entries": n, "key_bytes": key_bytes,
                             "bytes": n * key_bytes + 4 * n,
                             "chunks": chunks, "threads": threads,
                             "elapsed_s": spans.fields[0]["elapsed_s"]}]


def test_a_full_size_chunk_takes_the_processs_cores():
    """At the real chunk, one chunk's decode is split over every core the
    process may run on, up to a thread a PULL_PART_ENTRIES; a small table
    stays on the caller's thread."""
    cores = len(os.sched_getaffinity(0))
    t_keys, t_cnt = _table(21, 3 * table_mod.PULL_PART_ENTRIES + 5)
    with _PullSpans() as spans:
        table_mod._pull_table(t_keys, t_cnt, 3 * table_mod.PULL_PART_ENTRIES + 5, 21)
        table_mod._pull_table(t_keys, t_cnt, 100, 21)
    assert [f["threads"] for f in spans.fields] == [min(cores, 4), 1]
    assert [f["chunks"] for f in spans.fields] == [1, 1]


def test_pulls_from_several_threads_each_get_their_own_table(small_chunks):
    """Pulls running at once in more threads than cores, with a short
    switch interval, each equal their own table's decode."""
    tables = [_table(21 if i % 2 else 16, 300 + 37 * i, seed=i) for i in range(12)]
    got = [None] * len(tables)

    def pull(i):
        t_keys, t_cnt = tables[i]
        n = t_keys.numel() - 13
        got[i] = table_mod._pull_table(t_keys, t_cnt, n, 21 if i % 2 else 16)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=pull, args=(i,)) for i in range(len(tables))]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(w.is_alive() for w in workers)
    for i, (t_keys, t_cnt) in enumerate(tables):
        n = t_keys.numel() - 13
        k = 21 if i % 2 else 16
        np.testing.assert_array_equal(got[i][0], keys_to_codes(t_keys[:n].numpy(), k))
        np.testing.assert_array_equal(got[i][1], t_cnt[:n].numpy().astype(np.uint64))
