"""The device table's size limits, and a genome-shaped count across table
lifetimes, against the JAX package.

The limits of ``krust_tpu_torch/ops/table.py`` are entries at the H100's
memory, scaled by a device's own: every card the kernels build for
(``sm_90a``: Hopper, 64 to 141 GiB) must hold a lifetime's worst step
within the budget, and the limits grow with memory. The genome-shaped
count is near-all-distinct, as an assembly is, with the epoch and lifetime
limits patched small so that it crosses epoch flushes, part merges and
table lifetimes (k = 15 and 31, eager and chunked ingest), and is held
against ``krust_tpu``'s engine on XLA-CPU: equal tables (integers:
tolerance 0). Also: a merge frees its inputs before K2 runs, and the
host-side sum of the lifetimes' tables equals a concatenate-and-unique.
"""

import gc
import weakref

import jax
import numpy as np
import pytest
import torch

import krust_tpu.api as jax_api
import krust_tpu.utils.config as jax_config
import krust_tpu_torch.api as port_api
from krust_tpu_torch.io.input import Input
from krust_tpu_torch.models import engines
from krust_tpu_torch.ops import table as table_mod
from krust_tpu_torch.ops.keys import codes_to_keys
from krust_tpu_torch.utils import tracing
from krust_tpu_torch.utils.config import EngineConfig

CPU = torch.device("cpu")
GIB = 1 << 30
#: device memory of the Hopper cards the limits scale to, and the H100's own
MEMS = [64 * GIB, 80 * GIB, table_mod._REFERENCE_MEM, 94 * GIB, 96 * GIB, 141 * GIB]


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches():
    yield
    jax.clear_caches()


@pytest.fixture
def device_mem(monkeypatch):
    """Set the memory the table sees on its device; no env override."""
    monkeypatch.delenv("KRUST_EPOCH_ENTRIES", raising=False)
    monkeypatch.delenv("KRUST_PENDING_ENTRIES", raising=False)

    def set_mem(mem):
        monkeypatch.setattr(table_mod, "_device_mem_bytes", lambda device: mem)

    return set_mem


# --- the limits ---------------------------------------------------------------


@pytest.mark.parametrize("mem", MEMS)
def test_epoch_part_and_flush_fit_the_budget(device_mem, mem):
    """A part of a whole epoch resident beside the next epoch's flush, the
    first flush alone, and the flush after the part as a lifetime caps it
    (min(E, 2^31 - E) keys): all within the budget at the scaled limit."""
    device_mem(mem)
    e = table_mod.epoch_entry_limit(CPU)
    budget = table_mod.memory_budget(mem)
    flush = lambda n: table_mod.FLUSH_FIXED_BYTES + table_mod.FLUSH_BYTES_PER_KEY * n  # noqa: E731
    assert table_mod.epoch_peak_bytes(e) <= budget
    assert flush(e) <= budget
    second = min(e, table_mod.EPOCH_WINDOW_LIMIT - e)
    assert table_mod.PART_BYTES_PER_ENTRY * e + flush(second) <= budget


@pytest.mark.parametrize("mem", MEMS)
def test_pending_compaction_fits_the_budget(device_mem, mem):
    device_mem(mem)
    p = table_mod.DeviceTable(21, device=CPU)._pending_limit
    peak = table_mod.MERGE_RUNS_FIXED_BYTES + table_mod.MERGE_RUNS_BYTES_PER_ENTRY * p
    assert peak <= table_mod.memory_budget(mem)


@pytest.mark.parametrize("mem", MEMS)
def test_lifetime_merge_fits_the_budget(mem):
    """A lifetime's last merge (two copies of 12 B x 2^31 at a time, once
    each merge frees its inputs) fits every card the limits scale to."""
    assert table_mod.LIFETIME_MERGE_BYTES <= table_mod.memory_budget(mem)


def test_limits_grow_with_memory(device_mem):
    epoch, pending = [], []
    for mem in sorted(MEMS + [1 * GIB, 16 * GIB, 40 * GIB, 192 * GIB]):
        device_mem(mem)
        epoch.append(table_mod.epoch_entry_limit(CPU))
        pending.append(table_mod.DeviceTable(21, device=CPU)._pending_limit)
    assert epoch == sorted(epoch) and pending == sorted(pending)
    assert epoch[0] == 1 << 20 or epoch[0] < epoch[-1]


def test_limits_are_the_largest_that_fit():
    """Each constant is the largest multiple of 2^24 entries that fits the
    H100's budget under its fit: 2^24 more would not."""
    budget = table_mod.memory_budget(table_mod._REFERENCE_MEM)
    e = table_mod.EPOCH_ENTRY_LIMIT
    assert e % (1 << 24) == 0
    assert table_mod.epoch_peak_bytes(e) <= budget < table_mod.epoch_peak_bytes(e + (1 << 24))
    p = table_mod.DeviceTable.PENDING_ENTRY_LIMIT
    runs = lambda n: (table_mod.MERGE_RUNS_FIXED_BYTES  # noqa: E731
                      + table_mod.MERGE_RUNS_BYTES_PER_ENTRY * n)
    assert p % (1 << 24) == 0 and runs(p) <= budget < runs(p + (1 << 24))


# --- freeing as the merges go ----------------------------------------------------


def _compacted_part(rng, n, k, m):
    codes = np.sort(rng.choice(1 << 20, n, replace=False).astype(np.uint64))
    keys = np.full(m, np.iinfo(np.int64 if k > 16 else np.int32).max,
                   np.int64 if k > 16 else np.int32)
    keys[:n] = codes_to_keys(codes, k)
    cnt = np.zeros(m, np.int32)
    cnt[:n] = rng.integers(1, 9, n)
    return torch.from_numpy(keys), torch.from_numpy(cnt), n


def _table_dict(parts) -> dict:
    out: dict = {}
    for keys, cnt, n in parts:
        for key, c in zip(keys[:n].tolist(), cnt[:n].tolist()):
            out[key] = out.get(key, 0) + c
    return out


@pytest.mark.parametrize("k", [15, 31])
def test_part_merge_frees_its_inputs_before_k2(monkeypatch, k):
    """The parts a merge consumes are dead by the time K2 runs on the
    merged copy: weakrefs to every input tensor are cleared inside a
    patched ``rle_compact``; the merged table is unchanged."""
    rng = np.random.default_rng(k)
    table = table_mod.EpochTable(k, device=CPU)
    table._compacted = [_compacted_part(rng, n, k, m)
                        for n, m in ((900, 1024), (700, 1024), (300, 512))]
    refs = [weakref.ref(t) for part in table._compacted for t in part[:2]]
    expect = _table_dict(table._compacted)
    seen = []
    real = table_mod.rle_compact

    def rle(keys, cnt=None):
        gc.collect()
        seen.append(sum(r() is not None for r in refs))
        return real(keys, cnt)

    monkeypatch.setattr(table_mod, "rle_compact", rle)
    merged = table._finish()
    # two merges: parts 1 + 2 (4 inputs dead at K2), then that + part 3 (all 6)
    assert seen == [2, 0]
    assert _table_dict([merged]) == expect


def _concatenate_and_unique(tables):
    """The sum of host tables by concatenation, ``np.unique`` and ``np.add.at``."""
    if not tables:
        return np.zeros(0, np.uint64), np.zeros(0, np.uint64)
    uniq, inverse = np.unique(np.concatenate([t[0] for t in tables]), return_inverse=True)
    sums = np.zeros(uniq.shape[0], np.uint64)
    np.add.at(sums, inverse, np.concatenate([t[1] for t in tables]))
    return uniq, sums


class _Pulls:
    """A one-device table whose ``finalize`` hands out given host tables."""

    _device = CPU

    def __init__(self, tables):
        self.finalize = iter(tables).__next__


def test_merge_tables_equals_concatenate_and_unique(monkeypatch):
    """The host sum of the lifetimes' tables: shared keys, keys only one
    side has (before, between and after the other's), empty tables."""
    monkeypatch.setattr(table_mod, "EPOCH_WINDOW_LIMIT", 1)  # a pull a batch
    rng = np.random.default_rng(8)
    for sizes in ((0, 5), (5, 0), (1000, 300), (300, 1000), (2000, 2000), (1, 1)):
        tables = []
        for n in sizes:
            codes = np.sort(rng.choice(5000, n, replace=False)).astype(np.uint64)
            tables.append((codes, rng.integers(1, 1 << 40, n).astype(np.uint64)))
        exp = _concatenate_and_unique(tables)
        lifetimes = engines._Lifetimes(_Pulls((c.copy(), n.copy()) for c, n in tables), False)
        lifetimes.charge(1)
        got = lifetimes.result(21)
        np.testing.assert_array_equal(got.codes, exp[0])
        np.testing.assert_array_equal(got.counts, exp[1])


@pytest.mark.parametrize("threshold", [0, 700, 5000, 64_000_000])
@pytest.mark.parametrize("n_parts", [0, 1, 2, 7])
def test_host_accumulator_equals_concatenate_and_unique(threshold, n_parts):
    """The host engines' sum of chunk and record partials: merged whenever
    more than ``threshold`` entries are held, then at the end."""
    rng = np.random.default_rng(n_parts)
    tables = []
    for n in rng.integers(0, 900, n_parts):
        codes = np.sort(rng.choice(3000, n, replace=False)).astype(np.uint64)
        tables.append((codes, rng.integers(1, 1 << 40, n).astype(np.uint64)))
    exp = _concatenate_and_unique(tables)
    acc = engines._HostAccumulator(threshold)
    for codes, counts in tables:
        acc.add(codes.copy(), counts.copy())
    got = acc.result()
    np.testing.assert_array_equal(got[0], exp[0])
    np.testing.assert_array_equal(got[1], exp[1])
    assert got[0].dtype == got[1].dtype == np.uint64


#: the pull points of the lifetime rule, written out: a group is a batch on
#: each slot; at a group's first batch i the table is pulled before i when
#: the windows charged since the last pull plus slots x the batch's charge
#: reach the limit. ``fed`` batches are added, the rest only charged (a
#: rank that ran dry)
LIFETIME_CASES = {
    # charges 300 x5, 100, 300 at limit 1000: 900 + 300 before batch 3,
    # 700 + 300 before batch 6
    "one_device": (1, 1000, None, [300, 300, 300, 300, 300, 100, 300], 7, [3, 6]),
    "one_device_lsm": (1, 1000, None, [300, 300, 300, 300, 300, 100, 300], 7, [3, 6]),
    # 2 slots, 100 a batch, limit 500: 400 + 200 at batches 4 and 8, the
    # second while the rank is dry
    "two_slots": (2, 500, 100, [0] * 12, 7, [4, 8]),
    "two_slots_lsm": (2, 500, 100, [0] * 12, 7, [4, 8]),
    # 3 slots, 100 a batch, limit 700: 600 + 300 at batches 6 and 12; the
    # rank runs dry inside a group
    "three_slots": (3, 700, 100, [0] * 14, 8, [6, 12]),
}


@pytest.mark.parametrize("case", list(LIFETIME_CASES))
def test_lifetimes_pull_at_the_rules_batches(monkeypatch, case):
    from krust_tpu_torch.ops.keys import keys_to_codes
    from krust_tpu_torch.parallel import sharded
    from krust_tpu_torch.parallel.mesh import make_mesh

    slots, limit, charge, windows, fed, pulls = LIFETIME_CASES[case]
    lsm = case.endswith("_lsm")
    monkeypatch.setattr(table_mod, "EPOCH_WINDOW_LIMIT", limit)
    if slots == 1:
        table = (table_mod.DeviceTable if lsm else table_mod.EpochTable)(21, device=CPU)
    else:
        table = sharded._Slots(21, make_mesh(devices=["cpu"] * slots),
                               sharded.ShardedTable if lsm else sharded.EpochShardedTable)
    lifetimes = engines._Lifetimes(table, lsm, charge)
    seen = []
    finalize = table.finalize
    monkeypatch.setattr(table, "finalize", lambda: seen.append(lifetimes.batches) or finalize())
    rng = np.random.default_rng(slots)
    raw = []
    for i, w in enumerate(windows):
        charged = lifetimes.charge(w)
        assert charged == (charge or w)
        if i < fed:
            raw.append(torch.from_numpy(rng.integers(-(1 << 63), -(1 << 63) + 400, 50)))
            lifetimes.add(raw[-1], charged)
    got = lifetimes.result(21)
    assert seen == pulls + [len(windows)]
    assert got.histogram is None  # a sum of lifetimes
    exp = np.unique(keys_to_codes(torch.cat(raw).numpy(), 21), return_counts=True)
    np.testing.assert_array_equal(got.codes, exp[0])
    np.testing.assert_array_equal(got.counts, exp[1])


# --- a genome-shaped count across lifetimes ----------------------------------------


def _write_genome(path, rng, lengths):
    """Random bases, soft-masked runs and an N run in each record, 60 a
    line: an assembly's shape, near-all-distinct at k = 15 and 31."""
    acgt = np.frombuffer(b"ACGT", np.uint8)
    with open(path, "wb") as f:
        for i, n in enumerate(lengths):
            seq = acgt[rng.integers(0, 4, n)]
            masked = np.repeat(np.arange(n // 100 + 1) % 2 == 1, 100)[:n]
            seq = seq | (masked.astype(np.uint8) << 5)
            start = int(rng.integers(0, n - 200))
            seq[start:start + 150] = ord("N")
            f.write(f">chr{i + 1}\n".encode())
            for j in range(0, n, 60):
                f.write(seq[j:j + 60].tobytes() + b"\n")


_JAX_TABLES: dict = {}


@pytest.mark.parametrize("chunk", [None, 8192], ids=["eager", "chunked"])
@pytest.mark.parametrize("k", [15, 31])
def test_genome_count_crosses_flushes_merges_and_lifetimes(monkeypatch, tmp_path, k, chunk):
    """Batches of 2048 windows; epochs of 4096 raw keys; lifetimes of
    fewer than 10240 windows: each lifetime flushes two epochs and merges
    their parts, and the input spans three lifetimes."""
    rng = np.random.default_rng(31)
    path = str(tmp_path / "genome.fa")
    _write_genome(path, rng, [9000, 6000, 4000])
    monkeypatch.delenv("KRUST_EPOCH_ENTRIES", raising=False)
    monkeypatch.setattr(table_mod, "EPOCH_ENTRY_LIMIT", 4096)
    monkeypatch.setattr(table_mod, "EPOCH_WINDOW_LIMIT", 5 * 2048)
    seen = []
    collect = lambda kind, name, f: seen.append((name, f)) if kind == "span" else None  # noqa: E731
    tracing.add_collector(collect)
    try:
        got = port_api.count_with_input(
            Input.from_path(path), k,
            config=EngineConfig(block_windows=256, batch_rows=8, device="cpu",
                                ingest_chunk_bytes=chunk))
    finally:
        tracing.remove_collector(collect)
    names = [n for n, _ in seen]
    assert names.count("pull_table") >= 3  # lifetimes: one finalize each
    assert names.count("epoch_flush") >= 5 and names.count("part_merge") >= 2
    if k not in _JAX_TABLES:
        config = jax_config.EngineConfig(block_windows=256, batch_rows=8)
        _JAX_TABLES[k] = jax_api.count_with_input(jax_api.Input.from_path(path), k,
                                                  config=config)
    exp = _JAX_TABLES[k]
    assert got.distinct > 0.95 * (19000 - 3 * (k + 150))  # near-all-distinct
    np.testing.assert_array_equal(got.codes, exp.codes)
    np.testing.assert_array_equal(got.counts, exp.counts)
