"""One process counting over a mesh of local slots (``krust_tpu_torch.parallel``)
on CPU tensors.

An in-process mesh of n in {2, 3, 4, 8} CPU slots (repeats of the CPU
device, the counterpart of XLA's virtual host devices) against
``krust_tpu``'s ``count_sharded`` on its XLA-CPU mesh of the same n
(``tests/conftest.py`` gives 8 devices): k in {3, 5, 13, 16, 17, 21, 31,
32}, clean input (flat route), N-rich and quality-masked input (dense
route), the epoch and the LSM table, with small epochs and a small window
limit so that every slot flushes and merges parts and the slots exchange
several times; a last group of batches shorter than n, empty input and a
homopolymer skew; ``make_mesh`` with and without a process group; the
public surface on a mesh; the check entry points (``krust_tpu_torch.entry``).
Integer work: tables equal exactly. ``krust_tpu`` compiles per shape, so
its side keeps one geometry (and its LSM table, which compiles least).
"""

import json
import os
import random
import runpy
import sys

import jax
import numpy as np
import pytest
import torch

import krust_tpu
import krust_tpu.api as jax_api
import krust_tpu.parallel.sharded as jax_sharded
import krust_tpu.utils.tracing as jax_tracing
import krust_tpu_torch.api as port_api
from krust_tpu.io.reader import ParsedStreams as JaxStreams
from krust_tpu.parallel.mesh import make_mesh as jax_make_mesh
from krust_tpu.parallel.sharded import count_sharded as jax_count_sharded
from krust_tpu.utils.config import EngineConfig as JaxConfig
from krust_tpu_torch import entry as entry_mod
from krust_tpu_torch.builder import KmerCounter
from krust_tpu_torch.io import packer
from krust_tpu_torch.io.reader import ParsedStreams, streams_from_sequences
from krust_tpu_torch.kmer import INVALID_CODE
from krust_tpu_torch.models.engines import NumpyEngine
from krust_tpu_torch.ops import codec as codec_mod
from krust_tpu_torch.ops import fused_codec as fused_mod
from krust_tpu_torch.ops import table as table_mod
from krust_tpu_torch.ops.keys import keys_to_codes
from krust_tpu_torch.parallel import sharded as sharded_mod
from krust_tpu_torch.parallel.mesh import Mesh, init_distributed, make_mesh
from krust_tpu_torch.parallel.sharded import (
    EpochShardedTable, ShardedTable, _owner_of, count_sharded,
)
from krust_tpu_torch.utils import tracing
from krust_tpu_torch.utils.config import EngineConfig

import oracle

HERE = os.path.dirname(os.path.abspath(__file__))

N_SLOTS = [2, 3, 4, 8]
KS = [3, 5, 13, 16, 17, 21, 31, 32]
KINDS = ["clean", "n-rich", "quality"]
#: the port's geometry: 1024 windows a batch, 11 batches a stream (no n
#: of N_SLOTS divides 11, so every mesh ends on a group shorter than n)
W, ROWS, BATCHES = 128, 8, 11
#: krust_tpu's one geometry for every n: its dense path needs the rows of
#: a chip group (batch_rows rounded up to a multiple of n) to be a multiple
#: of 8, as 96 is on every mesh of N_SLOTS; a stream is one or two groups,
#: so few shapes compile
JAX_CFG = dict(block_windows=128, batch_rows=96, use_epoch_sort=False)


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches():
    yield
    jax.clear_caches()


def _cfg(**kw):
    return EngineConfig(device="cpu", **{"block_windows": W, "batch_rows": ROWS, **kw})


def _cpu_mesh(n):
    return make_mesh(devices=["cpu"] * n)


def _assert_tables_equal(got, exp):
    np.testing.assert_array_equal(got.codes, exp.codes)
    np.testing.assert_array_equal(got.counts, exp.counts)


def _stream(kind, k, seed):
    """(codes, qual, min_quality) of one record of BATCHES batches' windows:
    clean (flat route), or N-rich or quality-masked with ~6% of the bases
    bad, above the 1/32 line (dense route)."""
    rng = np.random.default_rng(seed)
    n = (BATCHES - 1) * ROWS * W + 560 + k - 1
    codes = rng.integers(0, 4, n, dtype=np.uint8)
    if k == 32:
        codes[:600] = 2  # keys with bit 63 set
    qual, min_quality = None, None
    if kind == "n-rich":
        codes[rng.random(n) < 0.06] = INVALID_CODE
    elif kind == "quality":
        qual = np.where(rng.random(n) < 0.06, ord("#"), ord("I")).astype(np.uint8)
        min_quality = 20
    return codes, qual, min_quality


#: krust_tpu's table of each (n, k, kind) case, computed once
_JAX_TABLES: dict = {}


def _jax_table(n, k, kind, codes, qual, min_quality):
    key = (n, k, kind)
    if key not in _JAX_TABLES:
        s = JaxStreams(codes, qual, 1, codes.shape[0])
        _JAX_TABLES[key] = jax_count_sharded(s, k, min_quality, mesh=jax_make_mesh(n),
                                             config=JaxConfig(**JAX_CFG))
    return _JAX_TABLES[key]


@pytest.fixture
def trace():
    """Spans and events of the sharded path, by name."""
    names = ("sharded_exchange", "sharded_encode", "shard_sizes", "gather_shards",
             "pull_table")
    seen = {name: [] for name in names}

    def collect(kind, name, fields):
        if name in seen:
            seen[name].append(fields)

    tracing.add_collector(collect)
    yield seen
    tracing.remove_collector(collect)


@pytest.fixture
def route(monkeypatch):
    """Counts the codec calls by route: flat (K1) and dense (K4)."""
    calls = {"flat": 0, "dense": 0}
    real_flat, real_dense = fused_mod.encode_windows, codec_mod.encode_dense

    def flat(*a):
        calls["flat"] += 1
        return real_flat(*a)

    def dense(*a):
        calls["dense"] += 1
        return real_dense(*a)

    monkeypatch.setattr(fused_mod, "encode_windows", flat)
    monkeypatch.setattr(codec_mod, "encode_dense", dense)
    return calls


#: each (n, k) once, the input class turning with both, so that every n
#: meets every class and every k meets every n
MATRIX = [(n, k, KINDS[(i + j) % 3]) for i, n in enumerate(N_SLOTS) for j, k in enumerate(KS)]


@pytest.mark.parametrize("epoch_sort", [True, False], ids=["epoch", "lsm"])
@pytest.mark.parametrize("n,k,kind", MATRIX, ids=[f"n{n}-k{k}-{kind}" for n, k, kind in MATRIX])
def test_local_mesh_equals_jax_mesh(monkeypatch, route, trace, n, k, kind, epoch_sort):
    """The port's n CPU slots against krust_tpu's n XLA-CPU devices. Each
    slot's epoch (or LSM pending set) is one batch, so every slot flushes
    and merges parts; an epoch ends every two groups of n batches, so the
    slots exchange several times and the host merges the lifetimes."""
    monkeypatch.setattr(sharded_mod, "MIN_SLOT_ENTRIES", 1)
    monkeypatch.setenv("KRUST_EPOCH_ENTRIES", str(n * ROWS * W))
    monkeypatch.setenv("KRUST_PENDING_ENTRIES", str(n * ROWS * W))
    monkeypatch.setattr(table_mod, "EPOCH_WINDOW_LIMIT", 3 * n * ROWS * W)
    codes, qual, min_quality = _stream(kind, k, 1000 * n + k)
    exp = _jax_table(n, k, kind, codes, qual, min_quality)
    s = ParsedStreams(codes, qual, 1, codes.shape[0])
    got = count_sharded(s, k, min_quality, mesh=_cpu_mesh(n),
                        config=_cfg(use_epoch_sort=epoch_sort))
    _assert_tables_equal(got, exp)
    assert got.distinct > 0
    dense = kind != "clean"
    assert (route["dense"] > 0) == dense and (route["flat"] > 0) == (not dense)
    assert len(trace["sharded_encode"]) == BATCHES == packer.batch_count(
        codes.shape[0], k, W, ROWS)
    groups = -(-BATCHES // n)
    assert len(trace["sharded_exchange"]) == (groups + 1) // 2  # every 2 groups, the last
    for sizes, pulled in zip(trace["shard_sizes"], trace["pull_table"]):
        assert len(sizes["sizes"]) == n and sum(sizes["sizes"]) == pulled["entries"]
    for ex in trace["sharded_exchange"]:  # slots that share a device send no wire bytes
        assert ex["devices"] == n and ex["wire_bytes"] == 0 and ex["sent_bytes"] > 0


#: (k, input class) of the per-shard cases: both key widths, both routes
SHARD_CASES = [(15, "clean"), (21, "n-rich"), (32, "quality")]


def _jax_shards(n, codes, qual, min_quality, k):
    """``krust_tpu``'s count on its n-device mesh, shard by shard: chip g's
    (codes, counts) of every exchange, joined over the exchanges, and the
    ``shard_sizes`` events."""
    chips = [[] for _ in range(n)]
    sizes = []
    real = jax_sharded.ShardedTable.exchange

    def exchange(self, *a, **kw):
        out = real(self, *a, **kw)
        if out is not None:
            m_hi, m_lo, m_cnt, n_m = (np.asarray(x) for x in out)
            for g in range(n):
                m = int(n_m[g])
                codes = m_hi[g, :m].astype(np.uint64) << np.uint64(32) | m_lo[g, :m]
                chips[g].append((codes, m_cnt[g, :m].astype(np.uint64)))
        return out

    def collect(kind, name, fields):
        if name == "shard_sizes":
            sizes.append(fields["sizes"])

    jax_tracing.add_collector(collect)
    jax_sharded.ShardedTable.exchange = exchange
    try:
        jax_count_sharded(JaxStreams(codes, qual, 1, codes.shape[0]), k, min_quality,
                          mesh=jax_make_mesh(n), config=JaxConfig(**JAX_CFG))
    finally:
        jax_sharded.ShardedTable.exchange = real
        jax_tracing.remove_collector(collect)
    return [_joined(c) for c in chips], sizes


def _joined(pieces):
    """(codes, counts) pieces of one shard, a key's counts summed, sorted."""
    table: dict = {}
    for codes, counts in pieces:
        for c, n in zip(codes.tolist(), counts.tolist()):
            table[c] = table.get(c, 0) + n
    return sorted(table.items())


@pytest.mark.parametrize("n", [3, 8])
@pytest.mark.parametrize("k,kind", SHARD_CASES, ids=[f"k{k}-{kind}" for k, kind in SHARD_CASES])
def test_each_slot_holds_its_jax_chips_shard(monkeypatch, trace, n, k, kind):
    """Slot g of the port's n CPU slots ends with the keys (and counts)
    that chip g of ``krust_tpu``'s n-device mesh ends with, and the sorted
    shard sizes are equal: the owner is ``krust_tpu``'s at every n, not
    only where n divides 4."""
    codes, qual, min_quality = _stream(kind, k, 7000 + 100 * n + k)
    exp, exp_sizes = _jax_shards(n, codes, qual, min_quality, k)
    slots = [[] for _ in range(n)]
    real = sharded_mod._exchange

    def exchange(parts, mesh, k_):
        shards = real(parts, mesh, k_)
        for g, (keys, cnt, m) in enumerate(shards):
            slots[g].append((keys_to_codes(keys[:m].numpy(), k),
                             cnt[:m].numpy().astype(np.uint64)))
        return shards

    monkeypatch.setattr(sharded_mod, "_exchange", exchange)
    got = count_sharded(ParsedStreams(codes, qual, 1, codes.shape[0]), k, min_quality,
                        mesh=_cpu_mesh(n), config=_cfg())
    assert got.distinct > 0
    for g in range(n):
        assert _joined(slots[g]) == exp[g], f"slot {g} != chip {g}"
    (sizes,) = [e["sizes"] for e in trace["shard_sizes"]]
    assert exp_sizes == [sorted(sizes)]


def test_the_geometry_ends_on_a_short_group():
    """Each n of N_SLOTS leaves a last group of fewer than n batches."""
    assert all(BATCHES % n for n in N_SLOTS)


@pytest.mark.parametrize("n", [2, 4, 8])
def test_batches_are_dealt_to_the_slots_in_turn(monkeypatch, n):
    """Slot i takes batches i, i + n, ...; the last group reaches only the
    first BATCHES mod n slots."""
    order = []
    real_add = table_mod.EpochTable.add

    def spy(self, keys, n_windows):
        order.append(id(self))
        return real_add(self, keys, n_windows)

    monkeypatch.setattr(table_mod.EpochTable, "add", spy)
    codes, _, _ = _stream("clean", 21, 7)
    count_sharded(ParsedStreams(codes, None, 1, codes.shape[0]), 21, mesh=_cpu_mesh(n),
                  config=_cfg())
    slots = order[:n]
    assert len(set(slots)) == n
    assert order == [slots[i % n] for i in range(BATCHES)]


@pytest.mark.parametrize("n", [2, 4, 8])
def test_empty_input(trace, n):
    empty = jax_count_sharded(krust_tpu.io.reader.streams_from_sequences([]), 5,
                              mesh=jax_make_mesh(n), config=JaxConfig(**JAX_CFG))
    got = count_sharded(streams_from_sequences([]), 5, mesh=_cpu_mesh(n), config=_cfg())
    _assert_tables_equal(got, empty)
    assert got.distinct == 0 and trace["shard_sizes"] == [{"sizes": [0] * n}]


@pytest.mark.parametrize("epoch_sort", [True, False], ids=["epoch", "lsm"])
@pytest.mark.parametrize("n", [3, 8])
def test_homopolymer_skew(trace, n, epoch_sort):
    """Every window is one key: one slot owns the whole table."""
    seqs = ["A" * 5000]
    exp = jax_count_sharded(krust_tpu.io.reader.streams_from_sequences(seqs), 21,
                            mesh=jax_make_mesh(n), config=JaxConfig(**JAX_CFG))
    got = count_sharded(streams_from_sequences(seqs), 21, mesh=_cpu_mesh(n),
                        config=_cfg(use_epoch_sort=epoch_sort))
    _assert_tables_equal(got, exp)
    assert got.to_string_dict() == {"A" * 21: 5000 - 21 + 1}
    (sizes,) = trace["shard_sizes"]
    owner = int(_owner_of(torch.tensor([np.iinfo(np.int64).min]), n))  # the all-A key
    assert sizes["sizes"] == [int(d == owner) for d in range(n)]


@pytest.mark.parametrize("n", [1, 2, 4])
def test_local_mesh_equals_the_oracle(n):
    """Records of every length around the batch edges, with Ns."""
    rng = random.Random(41 + n)
    seqs = [oracle.random_dna(rng, rng.randint(0, 700), "ACGTN") for _ in range(40)]
    got = count_sharded(streams_from_sequences(seqs), 11, mesh=_cpu_mesh(n), config=_cfg())
    assert got.to_string_dict() == oracle.count_sequences(seqs, 11)


def test_one_slot_runs_no_exchange(trace):
    """A mesh of one device is the one-device count: no exchange, no
    gather, the slot's own part pulled."""
    codes, _, _ = _stream("clean", 21, 3)
    s = ParsedStreams(codes, None, 1, codes.shape[0])
    got = count_sharded(s, 21, mesh=_cpu_mesh(1), config=_cfg())
    _assert_tables_equal(got, NumpyEngine().count(s, 21))
    assert trace["sharded_exchange"] == [] and trace["gather_shards"] == []
    assert trace["shard_sizes"] == [{"sizes": [got.distinct]}]


def test_slot_tables_share_the_budget(monkeypatch):
    """Each slot's epoch and LSM pending set is the device's over the mesh's
    slots, at least MIN_SLOT_ENTRIES."""
    monkeypatch.setenv("KRUST_EPOCH_ENTRIES", str(1 << 24))
    monkeypatch.setenv("KRUST_PENDING_ENTRIES", str(1 << 24))
    four = _cpu_mesh(4)
    for slot in range(4):
        assert EpochShardedTable(21, four, slot=slot)._epoch_limit == 1 << 22
        assert ShardedTable(21, four, slot=slot)._pending_limit == 1 << 22
    wide = _cpu_mesh(64)
    assert EpochShardedTable(21, wide)._epoch_limit == sharded_mod.MIN_SLOT_ENTRIES
    assert ShardedTable(21, wide)._pending_limit == sharded_mod.MIN_SLOT_ENTRIES


def test_a_batch_on_the_wrong_slot_raises():
    slots = sharded_mod._Slots(5, Mesh(None, 2, 0, torch.device("cpu"),
                                       (torch.device("cpu"), torch.device("meta"))),
                               EpochShardedTable)
    keys = torch.zeros(8, dtype=torch.int32)
    slots.add(keys, 8)
    with pytest.raises(ValueError, match="slot 1"):
        slots.add(keys, 8)


# --- the mesh ---------------------------------------------------------------------


def test_make_mesh_without_a_process_group(monkeypatch):
    monkeypatch.delenv("KRUST_PLATFORM", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    gpus = tuple(torch.device("cuda", i) for i in range(4))
    mesh = make_mesh()
    assert (mesh.group, mesh.size, mesh.rank, mesh.device, mesh.devices) == (
        None, 4, 0, gpus[0], gpus)
    assert make_mesh(2).devices == gpus[:2]
    assert make_mesh(4) == mesh
    with pytest.raises(ValueError, match="requested 5 devices, only 4 available"):
        make_mesh(5)
    with pytest.raises(ValueError, match="requested 0 devices"):
        make_mesh(0)
    assert make_mesh(device="cuda:2").devices == (gpus[2],)
    cpus = make_mesh(devices=["cpu"] * 3)
    assert (cpus.size, cpus.devices) == (3, (torch.device("cpu"),) * 3)
    assert make_mesh(2, devices=["cpu"] * 3).devices == (torch.device("cpu"),) * 2
    assert Mesh(None, 1, 0, torch.device("cpu")).devices == (torch.device("cpu"),)


def test_make_mesh_with_no_gpu_needs_a_device(monkeypatch):
    monkeypatch.delenv("KRUST_PLATFORM", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(2)
    assert make_mesh(devices=["cpu", "cpu"]).size == 2


def test_make_mesh_in_a_process_group(tmp_path):
    """A rank drives several slots: a device list, or n slots over the
    world's ranks on one named device."""
    init_distributed(f"file://{tmp_path / 'pg'}", rank=0, world_size=1, backend="gloo")
    try:
        mesh = make_mesh(device="cpu")
        assert (mesh.group, mesh.size, mesh.devices) == (
            torch.distributed.group.WORLD, 1, (torch.device("cpu"),))
        assert make_mesh(1, devices=["cpu"]) == mesh
        two = make_mesh(devices=["cpu"] * 2)
        assert (two.group, two.size, two.world, two.devices) == (
            torch.distributed.group.WORLD, 2, 1, (torch.device("cpu"),) * 2)
        assert make_mesh(2, device="cpu") == two
        assert make_mesh(2, devices=["cpu"] * 3) == two
        with pytest.raises(ValueError, match="rank 0: requested 4 devices, only 3"):
            make_mesh(4, devices=["cpu"] * 3)
    finally:
        torch.distributed.destroy_process_group()


@pytest.fixture
def gloo_one_rank(tmp_path):
    init_distributed(f"file://{tmp_path / 'pg'}", rank=0, world_size=1, backend="gloo")
    try:
        yield
    finally:
        torch.distributed.destroy_process_group()


@pytest.mark.parametrize("host_ranks", [1, 2, 4, 8])
def test_default_split_shares_the_host_gpus(monkeypatch, gloo_one_rank, host_ranks):
    """8 GPUs over the host's ranks (torchrun's ``LOCAL_WORLD_SIZE``): each
    local rank i drives its own g = 8 / ranks cards, ``cuda:i*g`` on."""
    monkeypatch.delenv("KRUST_PLATFORM", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", str(host_ranks))
    g = 8 // host_ranks
    driven = []
    for i in range(host_ranks):
        monkeypatch.setenv("LOCAL_RANK", str(i))
        mesh = make_mesh()
        assert mesh.devices == tuple(torch.device("cuda", i * g + j) for j in range(g))
        assert (mesh.size, mesh.world, mesh.device) == (g, 1, torch.device("cuda", i * g))
        assert make_mesh(1).devices == mesh.devices[:1]
        driven += mesh.devices
    assert sorted(d.index for d in driven) == list(range(8))  # no card twice


def test_default_split_counts_the_host_ranks_by_name(monkeypatch, gloo_one_rank):
    """Without ``LOCAL_WORLD_SIZE`` the host's ranks are those that share
    its name: here the one rank, so every GPU."""
    monkeypatch.delenv("KRUST_PLATFORM", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    assert make_mesh().devices == tuple(torch.device("cuda", i) for i in range(4))


def test_an_uneven_split_raises(monkeypatch, gloo_one_rank):
    monkeypatch.delenv("KRUST_PLATFORM", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 6)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    monkeypatch.setenv("LOCAL_RANK", "1")
    with pytest.raises(ValueError, match="6 GPUs do not split evenly over the host's 4 ranks"):
        make_mesh()
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)  # fewer cards than ranks
    with pytest.raises(ValueError, match="2 GPUs do not split evenly"):
        make_mesh()


@pytest.mark.parametrize("host_ranks,local_rank,first", [(1, 0, 0), (2, 1, 4), (4, 3, 6),
                                                          (8, 5, 5)])
def test_init_distributed_selects_the_first_device(monkeypatch, host_ranks, local_rank, first):
    """With NCCL, the rank's first device of the split, ``cuda:i*g``."""
    monkeypatch.delenv("KRUST_PLATFORM", raising=False)
    calls = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: calls.append(d))
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda backend, **kw: calls.append(backend))
    monkeypatch.setenv("LOCAL_WORLD_SIZE", str(host_ranks))
    monkeypatch.setenv("LOCAL_RANK", str(local_rank))
    init_distributed("localhost:1234")
    assert calls == ["nccl", torch.device("cuda", first)]


def test_init_distributed_counts_host_ranks_without_torchrun(monkeypatch, tmp_path):
    """Without ``LOCAL_WORLD_SIZE`` the group also takes gloo, for the
    gather of host names before the first device is selected."""
    monkeypatch.delenv("KRUST_PLATFORM", raising=False)
    calls = []
    real_init = torch.distributed.init_process_group

    def init(backend, **kw):  # CPU torch has no NCCL: record it, join on gloo
        calls.append(backend)
        real_init("gloo", **kw)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: calls.append(d))
    monkeypatch.setattr(torch.distributed, "init_process_group", init)
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    try:
        init_distributed(f"file://{tmp_path / 'pg'}", rank=0, world_size=1)
    finally:
        torch.distributed.destroy_process_group()
    assert calls == ["cpu:gloo,cuda:nccl", torch.device("cuda", 0)]


# --- the public surface on a mesh -------------------------------------------------


@pytest.mark.parametrize("name,min_quality,k,n", [("with_n.fa", None, 5, 4),
                                                   ("low_quality.fq", 20, 21, 2)])
def test_api_and_builder_on_a_mesh_match_jax(fixtures_dir, name, min_quality, k, n):
    path = str(fixtures_dir / name)
    cfg, jax_cfg = _cfg(batch_rows=1), JaxConfig(**JAX_CFG)
    mesh, jax_mesh = _cpu_mesh(n), jax_make_mesh(n)
    exp = jax_api.count_kmers_sharded_result(path, k, min_quality=min_quality, mesh=jax_mesh,
                                             config=jax_cfg)
    got = port_api.count_kmers_sharded_result(path, k, min_quality=min_quality, mesh=mesh,
                                              config=cfg)
    _assert_tables_equal(got, exp)
    assert port_api.count_kmers_sharded(path, k, min_quality=min_quality, mesh=mesh,
                                        config=cfg) == exp.to_string_dict()
    counter = KmerCounter.new().k(k).min_count(2).min_quality(min_quality).engine_config(cfg)
    assert counter.count_sharded(path, mesh=mesh) == krust_tpu.KmerCounter.new().k(
        k).min_count(2).min_quality(min_quality).engine_config(jax_cfg).count_sharded(
        path, mesh=jax_mesh)


# --- the check entry points --------------------------------------------------------


def test_entry_counts_a_slice():
    """K1 -> sort -> K2 at k = 21 on the CPU equals the numpy count of the
    same windows."""
    fn, (packed, invpos) = entry_mod.entry("cpu")
    keys, counts, n_unique = fn(packed, invpos)
    n = int(n_unique)
    codes = np.unpackbits(packed.numpy())[: 2 * ((1 << 16) + 20)].reshape(-1, 2)
    bases = (codes[:, 0] << 1 | codes[:, 1]).astype(np.uint8)
    bases[invpos.numpy()] = INVALID_CODE
    exp = NumpyEngine().count(ParsedStreams(bases, None, 1, bases.shape[0]), 21)
    assert n == exp.distinct and int(counts[:n].sum()) == exp.total
    np.testing.assert_array_equal(counts[:n].numpy(), exp.counts)


def test_entry_needs_a_gpu_unless_a_device_is_named(monkeypatch):
    monkeypatch.delenv("KRUST_PLATFORM", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry_mod.entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry_mod.main([])


@pytest.mark.parametrize("n", [1, 2, 4])
def test_dryrun_multichip_on_cpu_slots(capsys, n):
    assert entry_mod.main([str(n), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "entry OK" in out and f"dryrun_multichip OK: {n} devices" in out


def test_dryrun_multichip_raises_on_a_difference(monkeypatch):
    real = entry_mod.count_sharded

    def off_by_one(*a, **kw):
        got = real(*a, **kw)
        got.counts[0] += 1
        return got

    monkeypatch.setattr(entry_mod, "count_sharded", off_by_one)
    with pytest.raises(AssertionError, match="k=21"):
        entry_mod.dryrun_multichip(2, "cpu")


def test_sharded_local_tool_rehearses_on_cpu_slots(tmp_path, monkeypatch):
    """``tools/sharded_local.py --device cpu``: both inputs over 1 and 3 CPU
    slots, every table equal to the native core's, the rows written."""
    out = tmp_path / "rows.jsonl"
    monkeypatch.setenv("KRUST_ENGINE", "device")
    monkeypatch.setattr(sys, "argv", [
        "sharded_local.py", "--device", "cpu", "--reads-bases", "300000",
        "--genome-bases", "400000", "--cards", "1,3", "--out", str(out)])
    with pytest.raises(SystemExit) as done:
        runpy.run_path(os.path.join(HERE, os.pardir, "tools", "sharded_local.py"),
                       run_name="__main__")
    assert done.value.code == 0
    rows = [json.loads(line) for line in out.read_text().splitlines()]
    assert [(r.get("input"), r.get("cards")) for r in rows[:6]] == [
        ("reads", None), ("reads", 1), ("reads", 3),
        ("genome", None), ("genome", 1), ("genome", 3)]
    for head, one, three in (rows[0:3], rows[3:6]):
        assert one["equal_to_native"] and three["equal_to_native"]
        assert one["distinct"] == three["distinct"] == head["distinct"]
        assert one["exchanges"] == 0 and three["exchanges"] == 1
    assert rows[6]["dryrun_multichip"].startswith("dryrun_multichip OK: 3 devices")
