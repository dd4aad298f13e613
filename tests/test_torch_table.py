"""The port's LSM ``DeviceTable`` against ``krust_tpu.ops.table.DeviceTable``.

The same numpy batches, made from a seed, are added to both tables (JAX on
the CPU; the port on CPU tensors, so the RLE kernel's plain version runs
underneath) and the finalized (codes, counts) must be equal exactly
(integers: tolerance 0), and equal to a host dictionary count.
"""

import jax
import numpy as np
import pytest
import torch

from krust_tpu.models.engines import _HostAccumulator
from krust_tpu.ops.count import count_unique as jax_count_unique
from krust_tpu.ops.table import DeviceTable as JaxDeviceTable
from krust_tpu_torch.ops import table as table_mod
from krust_tpu_torch.ops.count import count_runs
from krust_tpu_torch.ops.keys import parts_from_numpy
from krust_tpu_torch.ops.table import DeviceTable

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches():
    yield
    jax.clear_caches()


def _batch(rng, n, k, key_space):
    """n random codes below ``key_space`` as (hi, lo, valid) planes."""
    codes = rng.integers(0, min(key_space, 1 << (2 * k)), size=n, dtype=np.uint64)
    valid = rng.random(n) < 0.9
    return (codes >> np.uint64(32)).astype(np.uint32), codes.astype(np.uint32), valid


def _add_both(port, ref, hi, lo, valid, k, expected, weighted):
    """One batch into both tables and the host dictionary. The JAX table
    takes the batch's compacted uniques; the port's takes the same part
    converted (``weighted``) or the raw sentinel keys with unit weights, as
    the engine feeds it."""
    n = hi.shape[0]
    u_hi, u_lo, u_cnt, _ = jax_count_unique(hi, lo, valid)
    ref.add(u_hi, u_lo, u_cnt, n)
    if weighted:
        port.add(*parts_from_numpy(np.asarray(u_hi), np.asarray(u_lo), np.asarray(u_cnt), k,
                                   zero_is_padding=True), n)
    else:
        keys, _ = parts_from_numpy(hi, lo, valid.astype(np.uint32), k, zero_is_padding=True)
        port.add(keys, None, n)
    for h, l, v in zip(hi.tolist(), lo.tolist(), valid.tolist()):
        if v:
            expected[(h << 32) | l] = expected.get((h << 32) | l, 0) + 1


def _assert_tables(port, ref, expected):
    codes, counts = port.finalize()
    r_codes, r_counts = ref.finalize()
    assert codes.dtype == np.uint64 and counts.dtype == np.uint64
    np.testing.assert_array_equal(codes, r_codes)
    np.testing.assert_array_equal(counts, r_counts)
    assert dict(zip(codes.tolist(), counts.tolist())) == expected


@pytest.mark.parametrize("weighted", [True, False], ids=["weighted-parts", "raw-keys"])
@pytest.mark.parametrize("max_parts", [2, 3, 8])
def test_table_matches_jax_and_host_merge(max_parts, weighted):
    rng = np.random.default_rng(max_parts)
    port, ref = DeviceTable(32, max_parts=max_parts, device=CPU), JaxDeviceTable(max_parts=max_parts)
    expected: dict[int, int] = {}
    for _ in range(10):
        hi, lo, valid = _batch(rng, 1000, 32, 1 << 33)
        lo %= 50
        _add_both(port, ref, hi, lo, valid, 32, expected, weighted)
    assert port.windows_this_epoch == ref.windows_this_epoch == 10_000
    _assert_tables(port, ref, expected)


def test_table_empty():
    codes, counts = DeviceTable(21, device=CPU).finalize()
    assert codes.shape == counts.shape == (0,)
    assert codes.dtype == counts.dtype == np.uint64


def test_table_all_invalid_batch():
    table = DeviceTable(21, max_parts=2, device=CPU)
    for _ in range(3):
        table.add(torch.full((64,), torch.iinfo(torch.int64).max), None, 64)
    codes, counts = table.finalize()
    assert codes.shape == counts.shape == (0,)


def test_table_epoch_flush_merges_in_host_acc():
    """The engine's window-limit flush: two table lifetimes merge exactly in
    the host accumulator."""
    rng = np.random.default_rng(1)
    acc, r_acc = _HostAccumulator(), _HostAccumulator()
    expected: dict[int, int] = {}
    for _epoch in range(2):
        port, ref = DeviceTable(32, max_parts=2, device=CPU), JaxDeviceTable(max_parts=2)
        for _ in range(4):
            hi, lo, valid = _batch(rng, 500, 32, 1 << 33)
            lo %= 20
            _add_both(port, ref, hi, lo, valid, 32, expected, weighted=True)
        acc.add(*port.finalize())
        r_acc.add(*ref.finalize())
    codes, counts = acc.result()
    r_codes, r_counts = r_acc.result()
    np.testing.assert_array_equal(codes, r_codes)
    np.testing.assert_array_equal(counts, r_counts)
    assert dict(zip(codes.tolist(), counts.tolist())) == expected


@pytest.mark.parametrize("k", [5, 15, 16, 17, 21, 31, 32])
def test_table_key_widths_match_jax(k):
    """Both key widths and the codes next to the sentinel (k = 16: bit 31
    set; k = 32: bit 63 set)."""
    rng = np.random.default_rng(2 + k)
    port, ref = DeviceTable(k, max_parts=2, device=CPU), JaxDeviceTable(k, max_parts=2)
    expected: dict[int, int] = {}
    top = (1 << (2 * k)) - 1
    for _ in range(5):
        hi, lo, valid = _batch(rng, 600, k, 1 << 50)
        hi[:3], lo[:3] = (top - 1) >> 32, (top - 1) & 0xFFFFFFFF
        _add_both(port, ref, hi, lo, valid, k, expected, weighted=bool(k % 2))
    _assert_tables(port, ref, expected)


def test_table_reuse_after_finalize():
    rng = np.random.default_rng(5)
    port, ref = DeviceTable(17, max_parts=3, device=CPU), JaxDeviceTable(17, max_parts=3)
    for _life in range(3):
        expected: dict[int, int] = {}
        for _ in range(4):
            _add_both(port, ref, *_batch(rng, 300, 17, 40), 17, expected, weighted=False)
        _assert_tables(port, ref, expected)
        assert port.windows_this_epoch == 0


def test_pending_entries_env_forces_a_merge_per_add(monkeypatch):
    """KRUST_PENDING_ENTRIES below a batch: every add compacts, each merge
    sorts the batch with the table, and the result is unchanged."""
    merges = []
    real = table_mod.merge_runs
    monkeypatch.setattr(table_mod, "merge_runs",
                        lambda keys, cnt: merges.append(keys.numel()) or real(keys, cnt))
    monkeypatch.setenv("KRUST_PENDING_ENTRIES", "100")
    rng = np.random.default_rng(6)
    port, ref = DeviceTable(21, device=CPU), JaxDeviceTable(21)
    expected: dict[int, int] = {}
    for _ in range(6):
        _add_both(port, ref, *_batch(rng, 256, 21, 90), 21, expected, weighted=False)
    assert len(merges) == 6
    # the table is the first round_pow2(n) entries: 90 keys -> at most 128
    assert merges[0] == 256 and all(256 < m <= 256 + 128 for m in merges[1:])
    _assert_tables(port, ref, expected)


def test_pending_limit_scales_and_counts_the_table_in(monkeypatch):
    monkeypatch.delenv("KRUST_PENDING_ENTRIES", raising=False)
    assert DeviceTable(21, device=CPU)._pending_limit == DeviceTable.PENDING_ENTRY_LIMIT
    # the limit is the H100's own; a card of twice its memory gets twice it
    monkeypatch.setattr(table_mod, "_device_mem_bytes", lambda device: table_mod._REFERENCE_MEM)
    assert DeviceTable(21, device=CPU)._pending_limit == DeviceTable.PENDING_ENTRY_LIMIT
    monkeypatch.setattr(table_mod, "_device_mem_bytes",
                        lambda device: 2 * table_mod._REFERENCE_MEM)
    assert DeviceTable(21, device=CPU)._pending_limit == 2 * DeviceTable.PENDING_ENTRY_LIMIT
    # a table near the limit leaves the floor of limit / 8 pending entries
    monkeypatch.setenv("KRUST_PENDING_ENTRIES", "800")
    merges = []
    real = table_mod.merge_runs
    monkeypatch.setattr(table_mod, "merge_runs",
                        lambda keys, cnt: merges.append(keys.numel()) or real(keys, cnt))
    table = DeviceTable(21, max_parts=100, device=CPU)
    keys = torch.arange(1024, dtype=torch.int64) + torch.iinfo(torch.int64).min
    table.add(keys, None, 1024)  # 1024 >= 800: compacts; the table holds 1024
    for _ in range(2):
        table.add(keys[:40], None, 40)  # 80 < 800 // 8: pending
    assert merges == [1024]
    table.add(keys[:40], None, 40)  # 120 >= 100: compacts with the table
    assert merges == [1024, 120 + 1024]
    codes, counts = table.finalize()
    assert codes.tolist() == list(range(1024))
    assert counts.tolist() == [4] * 40 + [1] * 984


def test_table_slice_does_not_alias_the_merge_output(monkeypatch):
    """The resolved table is a copy of the first round_pow2(n) entries, so
    the full-length merge output can be freed."""
    outputs = []
    real = table_mod.merge_runs

    def spy(keys, cnt):
        out = real(keys, cnt)
        outputs.append(out)
        return out

    monkeypatch.setattr(table_mod, "merge_runs", spy)
    table = DeviceTable(21, max_parts=2, device=CPU)
    rng = np.random.default_rng(7)
    for _ in range(2):
        keys, _ = parts_from_numpy(*_batch(rng, 4096, 21, 100)[:2], np.ones(4096, np.uint32), 21)
        table.add(keys, None, 4096)
    assert table._merge is not None and table._table is None  # the n-sync is deferred
    table._resolve()
    t_keys, t_cnt, n = table._table
    m_keys, m_cnt, _ = outputs[0]
    assert n == 100 and t_keys.numel() == t_cnt.numel() == 128 < m_keys.numel() == 8192
    assert t_keys.untyped_storage().data_ptr() != m_keys.untyped_storage().data_ptr()
    assert t_cnt.untyped_storage().data_ptr() != m_cnt.untyped_storage().data_ptr()
    assert t_keys.untyped_storage().nbytes() == 128 * 8


def test_add_defers_the_sync(monkeypatch):
    """``add`` never reads n back itself: the merge it dispatches is resolved
    by the next compaction or by ``finalize``."""
    reads = []
    real = DeviceTable._resolve

    def resolve(self):  # reads n back exactly when a merge is in flight
        if self._merge is not None:
            reads.append(1)
        real(self)

    monkeypatch.setattr(DeviceTable, "_resolve", resolve)
    table = DeviceTable(21, max_parts=2, device=CPU)
    keys = torch.arange(64, dtype=torch.int64)
    table.add(keys, None, 64)
    table.add(keys, None, 64)  # compacts: dispatches merge 1, nothing to resolve
    assert reads == []
    table.add(keys, None, 64)
    table.add(keys, None, 64)  # compacts: resolves merge 1 first
    assert reads == [1]
    table.finalize()
    assert reads == [1, 1]


def test_weighted_parts_from_count_runs():
    """``count_runs`` gives the weighted part of a batch: adding those equals
    adding the raw keys."""
    rng = np.random.default_rng(8)
    a, b = DeviceTable(16, max_parts=3, device=CPU), DeviceTable(16, max_parts=3, device=CPU)
    for _ in range(5):
        hi, lo, valid = _batch(rng, 500, 16, 70)
        keys, _ = parts_from_numpy(hi, lo, valid.astype(np.uint32), 16, zero_is_padding=True)
        a.add(keys, None, 500)
        b.add(*count_runs(keys, torch.ones(500, dtype=torch.bool)), 500)
    for x, y in zip(a.finalize(), b.finalize()):
        np.testing.assert_array_equal(x, y)
