"""The port's sharded count (``krust_tpu_torch.parallel``) on CPU tensors.

A world of one in process (no process group, and a one-rank gloo group)
against the brute-force oracle in ``tests/oracle.py``, the numpy engine and
``krust_tpu``'s ``count_sharded`` on its 8-device XLA-CPU mesh; both
tables, both codec routes, quality masks, empty input, homopolymer skew,
several batches and exchanges forced by the window limit. Then 2 ranks on
gloo, each in its own process (``tests/torch_mp_worker.py``): the shards
must be disjoint and their union exact; 4 ranks and the k = 1..32 sweep
are ``slow``. Integer work: tables equal exactly.
"""

import json
import os
import random
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import krust_tpu
import krust_tpu.api as jax_api
import krust_tpu_torch
import krust_tpu_torch.api as port_api
from krust_tpu.parallel.mesh import make_mesh as jax_make_mesh
from krust_tpu.parallel.sharded import _owner_of as jax_owner_of
from krust_tpu.parallel.sharded import count_sharded as jax_count_sharded
from krust_tpu_torch.builder import KmerCounter
from krust_tpu_torch.io import packer
from krust_tpu_torch.io.reader import ParsedStreams, streams_from_sequences
from krust_tpu_torch.kmer import INVALID_CODE, unpack_many
from krust_tpu_torch.models.engines import NumpyEngine
from krust_tpu_torch.ops import codec as codec_mod
from krust_tpu_torch.ops import fused_codec as fused_mod
from krust_tpu_torch.ops import table as table_mod
from krust_tpu_torch.ops.keys import codes_to_keys, keys_to_codes
from krust_tpu_torch.parallel import mesh as mesh_mod
from krust_tpu_torch.parallel.mesh import init_distributed, make_mesh
from krust_tpu_torch.parallel.sharded import (
    EpochShardedTable, ShardedTable, _owner_of, count_sharded,
)
from krust_tpu_torch.utils import tracing
from krust_tpu_torch.utils.config import EngineConfig

import oracle
import torch_mp_worker

HERE = os.path.dirname(os.path.abspath(__file__))


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches():
    yield
    jax.clear_caches()


def _cfg(**kw):
    kw = {"block_windows": 128, "batch_rows": 16, **kw}
    return EngineConfig(device="cpu", **kw)


def _to_dict(pc):
    return dict(zip(unpack_many(pc.codes, pc.k), pc.counts.tolist()))


def _assert_tables_equal(got, exp):
    np.testing.assert_array_equal(got.codes, exp.codes)
    np.testing.assert_array_equal(got.counts, exp.counts)


@pytest.fixture
def trace():
    """Spans and events of the sharded path, by name."""
    seen = {"sharded_exchange": [], "sharded_encode": [], "shard_sizes": []}

    def collect(kind, name, fields):
        if name in seen:
            seen[name].append(fields)

    tracing.add_collector(collect)
    yield seen
    tracing.remove_collector(collect)


@pytest.fixture
def gloo_world_of_one(tmp_path):
    """A one-rank gloo group: the exchange's collectives run in process."""
    init_distributed(f"file://{tmp_path / 'pg'}", rank=0, world_size=1, backend="gloo")
    try:
        yield
    finally:
        torch.distributed.destroy_process_group()


# --- a world of one, in process ----------------------------------------------------


@pytest.mark.parametrize("k", [3, 5, 17, 21, 31])
def test_sharded_equals_oracle(k):
    rng = random.Random(123 + k)
    seqs = [oracle.random_dna(rng, rng.randint(0, 300), "ACGTN") for _ in range(30)]
    got = count_sharded(streams_from_sequences(seqs), k, config=_cfg())
    assert _to_dict(got) == oracle.count_sequences(seqs, k)


@pytest.mark.parametrize("k", [5, 21])
def test_sharded_equals_jax_sharded(k):
    """The port's world of one against ``krust_tpu``'s 8-device mesh."""
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8 virtual devices tests/conftest.py provides")
    from krust_tpu.io.reader import streams_from_sequences as jax_streams
    from krust_tpu.utils.config import EngineConfig as JaxConfig

    rng = random.Random(123 + k)
    seqs = [oracle.random_dna(rng, rng.randint(0, 300), "ACGTN") for _ in range(30)]
    exp = jax_count_sharded(jax_streams(seqs), k, mesh=jax_make_mesh(8),
                            config=JaxConfig(block_windows=128, batch_rows=16))
    _assert_tables_equal(count_sharded(streams_from_sequences(seqs), k, config=_cfg()), exp)


def _stream(kind, rng, n):
    """(codes, qual, min_quality, dense): a clean or quality-masked stream on
    the flat route, N-rich and quality-masked ones on the dense route."""
    codes = rng.integers(0, 4, n, dtype=np.uint8)
    qual, min_quality = None, None
    if kind == "n-rich-dense":
        codes[rng.random(n) < 0.15] = INVALID_CODE
    elif kind != "clean":
        low = 0.15 if kind == "quality-dense" else 0.02
        qual = np.where(rng.random(n) < low, ord("#"), ord("I")).astype(np.uint8)
        min_quality = 20
    return codes, qual, min_quality, kind.endswith("dense")


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


@pytest.mark.parametrize("epoch_sort", [True, False], ids=["epoch", "lsm"])
@pytest.mark.parametrize("kind", ["clean", "quality", "n-rich-dense", "quality-dense"])
@pytest.mark.parametrize("k", [1, 16, 17, 32])
def test_tables_and_routes_match_numpy(route, monkeypatch, trace, k, kind, epoch_sort):
    """Both tables on both codec routes equal the numpy engine, with an
    exchange every two batches (the window limit at three batches' charge)."""
    rng = np.random.default_rng(700 + k + len(kind))
    codes, qual, min_quality, dense = _stream(kind, rng, 9000)
    if k == 32:
        codes[:600] = np.where(codes[:600] == INVALID_CODE, INVALID_CODE, 2)  # bit 63 set
    cfg = _cfg(block_windows=256, batch_rows=8, use_epoch_sort=epoch_sort)
    monkeypatch.setattr(table_mod, "EPOCH_WINDOW_LIMIT", 3 * 8 * 256)
    s = ParsedStreams(codes, qual, 1, 9000)
    got = count_sharded(s, k, min_quality, config=cfg)
    _assert_tables_equal(got, NumpyEngine().count(s, k, min_quality))
    assert (route["dense"] > 0) == dense and (route["flat"] > 0) == (not dense)
    steps = packer.batch_count(9000, k, 256, 8)
    assert len(trace["sharded_encode"]) == steps == 5
    assert len(trace["shard_sizes"]) == 3  # two batches an exchange, then the last
    assert trace["sharded_exchange"] == []  # a world of one runs no collective


def test_sharded_quality():
    rng = random.Random(77)
    records = []
    for _ in range(12):
        n = rng.randint(0, 150)
        seq = oracle.random_dna(rng, n)
        records.append((seq, "".join(chr(rng.randint(33, 73)) for _ in range(n))))
    k, min_q = 7, 20
    streams = streams_from_sequences([s for s, _ in records], [q.encode() for _, q in records])
    got = count_sharded(streams, k, min_quality=min_q, config=_cfg())
    assert _to_dict(got) == oracle.count_sequences(records, k, min_quality=min_q)


def test_sharded_empty(trace):
    got = count_sharded(streams_from_sequences([]), 5, config=_cfg())
    assert got.distinct == 0
    assert len(trace["sharded_encode"]) == 1 and trace["shard_sizes"] == [{"sizes": [0]}]


def test_sharded_skew_homopolymer():
    """All windows identical: every entry has one owner."""
    got = count_sharded(streams_from_sequences(["A" * 2000]), 21, config=_cfg())
    assert _to_dict(got) == {"A" * 21: 2000 - 21 + 1}


def test_multibatch_sharded(trace):
    rng = random.Random(99)
    seqs = [oracle.random_dna(rng, 600) for _ in range(10)]
    cfg = _cfg(block_windows=64, batch_rows=8)
    got = count_sharded(streams_from_sequences(seqs), 11, config=cfg)
    assert _to_dict(got) == oracle.count_sequences(seqs, 11)
    assert len(trace["sharded_encode"]) > 5


@pytest.mark.parametrize("k", [5, 21])
def test_exchange_in_a_one_rank_group(gloo_world_of_one, trace, k):
    """With a process group the exchange runs even for one rank: owner
    order, the split sizes through ``all_to_all_single``, then K3 and K2.
    Every entry is sent once (key bytes + 4), and none leaves the rank's
    one device."""
    rng = random.Random(5 + k)
    seqs = [oracle.random_dna(rng, rng.randint(0, 400), "ACGTN") for _ in range(40)]
    got = count_sharded(streams_from_sequences(seqs), k, config=_cfg())
    assert _to_dict(got) == oracle.count_sequences(seqs, k)
    (ex,) = trace["sharded_exchange"]
    assert ex["devices"] == 1
    assert ex["sent_bytes"] == got.distinct * (4 if k <= 16 else 8) + 4 * got.distinct
    assert ex["wire_bytes"] == ex["process_bytes"] == 0
    assert trace["shard_sizes"] == [{"sizes": [got.distinct]}]


def test_window_limit_exchanges_stay_exact_in_a_group(gloo_world_of_one, trace, monkeypatch):
    """Exchanges at every step (the charge alone reaches the window limit):
    each epoch's shard is pulled and the host merges them."""
    monkeypatch.setattr(table_mod, "EPOCH_WINDOW_LIMIT", 1)
    rng = random.Random(31)
    seqs = [oracle.random_dna(rng, 500, "ACGTN") for _ in range(12)]
    got = count_sharded(streams_from_sequences(seqs), 13, config=_cfg(batch_rows=8))
    assert _to_dict(got) == oracle.count_sequences(seqs, 13)
    assert len(trace["sharded_exchange"]) == len(trace["sharded_encode"]) + 1


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("keys", ["random", "consecutive"])
def test_owner_of_spreads_keys(dtype, keys):
    """2^16 keys over 4 owners: each within 10% of the mean."""
    info = torch.iinfo(dtype)
    if keys == "random":
        g = torch.Generator().manual_seed(3)
        k = torch.randint(info.min, info.max, (1 << 16,), generator=g, dtype=dtype)
    else:  # the biased codes of one region of the key space
        k = (torch.arange(1 << 16, dtype=torch.int64) + info.min + 12345).to(dtype)
    owner = _owner_of(k, 4)
    assert owner.dtype == torch.int64 and int(owner.min()) >= 0 and int(owner.max()) < 4
    per = torch.bincount(owner, minlength=4)
    assert torch.all((per - (1 << 14)).abs() < (1 << 14) // 10), per


@pytest.mark.parametrize("n", [2, 3, 4, 6, 8, 16])
@pytest.mark.parametrize("k", [15, 16, 21, 31, 32])
def test_owner_of_matches_jax(k, n):
    """The owner of each key is ``krust_tpu``'s owner chip of its code, at
    every n (the hash of the code's halves, not of the biased key's):
    2^14 random codes, the top of the code space (bit 63 set at k = 32)
    and the ends of it."""
    rng = np.random.default_rng(1000 * k + n)
    top = (1 << (2 * k)) - 1
    codes = np.concatenate([
        rng.integers(0, top, 1 << 14, dtype=np.uint64, endpoint=True),
        np.array([0, 1, top - 1, top, top >> 1, (top >> 1) + 1], np.uint64),
    ])
    hi, lo = (codes >> np.uint64(32)).astype(np.uint32), codes.astype(np.uint32)
    got = _owner_of(torch.from_numpy(codes_to_keys(codes, k)), n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_owner_of(hi, lo, n)))


def test_no_cpu_fallback(monkeypatch):
    """Without CUDA the sharded path runs only where the config names the
    CPU."""
    monkeypatch.delenv("KRUST_PLATFORM", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    s = streams_from_sequences(["ACGTACGTAC"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        count_sharded(s, 3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        count_sharded(s, 3, config=EngineConfig())
    assert count_sharded(s, 3, config=_cfg()).distinct > 0


def test_make_mesh_and_init_distributed(monkeypatch, tmp_path):
    monkeypatch.delenv("KRUST_PLATFORM", raising=False)
    mesh = make_mesh(device="cpu")
    assert (mesh.group, mesh.size, mesh.rank, mesh.device) == (None, 1, 0, torch.device("cpu"))
    assert make_mesh(1, device="cpu") == mesh
    with pytest.raises(ValueError, match="2 devices"):
        make_mesh(2, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setenv("LOCAL_RANK", "3")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    # no process group: every visible GPU, whatever LOCAL_RANK says
    every = make_mesh()
    assert every.devices == tuple(torch.device("cuda", i) for i in range(4))
    assert (every.group, every.size, every.device) == (None, 4, torch.device("cuda", 0))
    calls = []
    monkeypatch.setattr(mesh_mod.dist, "init_process_group",
                        lambda *a, **kw: calls.append((a, kw)))
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: calls.append(d))
    init_distributed("localhost:1234", rank=1, world_size=2)
    init_distributed(f"file://{tmp_path}/pg", backend="gloo")
    assert calls == [(("nccl",), {"init_method": "tcp://localhost:1234", "rank": 1,
                                  "world_size": 2}), torch.device("cuda", 3),
                     (("gloo",), {"init_method": f"file://{tmp_path}/pg"})]


def test_sharded_tables_exchange_their_finished_part(monkeypatch):
    """In a world of one ``exchange`` hands back the finished part; the
    epoch table's limit is the device budget over the world size, at least
    2^20 entries."""
    monkeypatch.setenv("KRUST_EPOCH_ENTRIES", str(1 << 24))
    mesh = make_mesh(device="cpu")
    assert EpochShardedTable(21, mesh)._epoch_limit == 1 << 24
    wide = mesh_mod.Mesh(None, 64, 0, torch.device("cpu"))
    assert EpochShardedTable(21, wide)._epoch_limit == 1 << 20
    rng = np.random.default_rng(4)
    raw = [torch.from_numpy(rng.integers(-(1 << 63), -(1 << 63) + 5000, 3000)) for _ in range(4)]
    epoch, lsm = EpochShardedTable(21, mesh), ShardedTable(21, mesh, max_parts=2)
    epoch._epoch_limit = 4000  # an epoch flush every second add
    for keys in raw:
        epoch.add(keys, 3000)
        lsm.add(keys, None, 3000)
    exp = np.unique(keys_to_codes(torch.cat(raw).numpy(), 21), return_counts=True)
    for table in (epoch, lsm):
        o_keys, o_cnt, n = table.exchange()
        np.testing.assert_array_equal(keys_to_codes(o_keys[:n].numpy(), 21), exp[0])
        np.testing.assert_array_equal(o_cnt[:n].numpy(), exp[1])
        assert table.windows_this_epoch == 0 and table.exchange()[2] == 0


@pytest.mark.parametrize("n,k,w,rows", [(0, 5, 128, 8), (4, 5, 128, 8), (132, 5, 128, 8),
                                        (133, 5, 128, 1), (100_000, 21, 128, 8),
                                        (100_000, 21, 256, 3), (5000, 32, 8, 8)])
def test_batch_count_is_what_the_packers_cut(n, k, w, rows):
    """Every rank counts its steps with ``batch_count``: it must equal the
    batches each route yields (the flat layout holds no w < k - 1)."""
    codes = np.random.default_rng(n).integers(0, 4, n, dtype=np.uint8)
    steps = packer.batch_count(n, k, w, rows)
    assert len(list(packer.pack_buffer_2bit(codes, None, k, None, w, rows))) == steps
    flat = packer.flat_batches(codes, None, k, None, w, rows)
    assert (flat is None) == (w < k - 1)
    assert flat is None or len(list(flat)) == steps


# --- the public surface ------------------------------------------------------------


@pytest.mark.parametrize("name,min_quality,k", [("with_n.fa", None, 5),
                                                 ("low_quality.fq", 20, 21)])
def test_api_and_builder_match_jax(fixtures_dir, name, min_quality, k):
    from krust_tpu.utils.config import EngineConfig as JaxConfig

    path = str(fixtures_dir / name)
    cfg, jax_cfg = _cfg(), JaxConfig(block_windows=128, batch_rows=16)
    exp = jax_api.count_kmers_sharded_result(path, k, min_quality=min_quality, config=jax_cfg)
    got = port_api.count_kmers_sharded_result(path, k, min_quality=min_quality, config=cfg)
    _assert_tables_equal(got, exp)
    assert port_api.count_kmers_sharded(path, k, min_quality=min_quality, config=cfg) == (
        _to_dict(exp))
    counter = KmerCounter.new().k(k).min_count(2).min_quality(min_quality).engine_config(cfg)
    assert counter.count_sharded(path) == krust_tpu.KmerCounter.new().k(k).min_count(
        2).min_quality(min_quality).engine_config(jax_cfg).count_sharded(path)


def test_exports_match_jax():
    """The port's top level and ``io`` export what ``krust_tpu``'s do, apart
    from the byte-per-base packer helpers the port removed for good."""
    import krust_tpu.io as jax_io
    import krust_tpu_torch.io as port_io
    from krust_tpu_torch.io import MmapFasta
    from krust_tpu_torch.io.mmapfile import MmapFasta as Mapped

    assert MmapFasta is Mapped is krust_tpu_torch.MmapFasta
    assert set(krust_tpu_torch.__all__) == set(krust_tpu.__all__)
    assert set(jax_io.__all__) - set(port_io.__all__) == {"PackedBatch", "pack_buffer",
                                                          "blockize"}
    assert set(port_io.__all__) <= set(jax_io.__all__)
    assert {"count_sharded", "make_mesh", "init_distributed", "ShardedTable",
            "EpochShardedTable", "CapacityOverflow"} <= set(krust_tpu_torch.parallel.__all__)


# --- several ranks, one process each (gloo) -----------------------------------------

#: the cases one spawn of the worker runs; ``route`` is what every rank's
#: codec calls must be
MP_CASES = [
    {"name": "clean_k5", "k": 5, "alphabet": "ACGT", "route": "flat"},
    {"name": "clean_k21", "k": 21, "alphabet": "ACGT", "route": "flat"},
    {"name": "nrich_k5", "k": 5, "alphabet": "ACGTN", "route": "dense"},
    {"name": "nrich_k21", "k": 21, "alphabet": "ACGTN", "route": "dense"},
    {"name": "lsm_k17", "k": 17, "alphabet": "ACGTN", "epoch_sort": False},
    # one rank holds nearly everything, the others run dry first; an
    # exchange every two steps, several of them during the dry steps
    {"name": "unequal_k21", "k": 21, "alphabet": "ACGT", "unequal": True,
     "window_limit": 3, "max_len": 900},
    {"name": "unequal_dense_k5", "k": 5, "alphabet": "ACGTN", "unequal": True,
     "window_limit": 3, "max_len": 900, "epoch_sort": False},
    # the reference's mesh-shape independence input
    {"name": "independence_k21", "k": 21, "alphabet": "ACGT", "seed": 55, "n_seqs": 8,
     "max_len": 400},
    {"name": "skew_epoch", "skew": True, "n_keys": 3000},
    {"name": "skew_lsm", "skew": True, "n_keys": 3000, "epoch_sort": False},
]
for _c in MP_CASES:
    _c.setdefault("seed", 1234)
    _c.setdefault("n_seqs", 40)
    _c.setdefault("max_len", 300)


def _spawn(tmp_path, world, cases, slots=None):
    """Run ``cases`` on ``world`` gloo ranks, each of ``slots`` CPU slots
    when given; {case name: [(codes, counts, flat calls, dense calls[,
    exchanges]) of each rank]}. A case's window limit is in batches of
    every rank, whatever its slots, so that with several slots the feed's
    exchange steps (a group of batches) and the charge part."""
    env = dict(os.environ, PYTHONPATH=os.path.dirname(HERE))
    env.pop("KRUST_ENGINE", None)
    worker = os.path.join(HERE, "torch_mp_worker.py")
    init = tmp_path / "pg"
    cases = [dict(c, window_limit=c["window_limit"] * world * 8 * 128)
             if c.get("window_limit") else c for c in cases]
    procs = [subprocess.Popen(
        [sys.executable, worker, str(r), str(world), str(init), str(tmp_path),
         json.dumps(cases)] + ([str(slots)] if slots else []),
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE) for r in range(world)]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
                q.communicate()
            pytest.fail("gloo workers timed out")
        outs.append((p.returncode, out.decode(), err.decode()))
    for rc, out, err in outs:
        assert rc == 0, f"worker failed:\n{out}\n{err}"
    shards = {}
    for c in cases:
        shards[c["name"]] = []
        for r in range(world):
            z = np.load(tmp_path / f"{c['name']}_{r}.npz")
            shards[c["name"]].append((z["codes"], z["counts"], int(z["flat"]), int(z["dense"]))
                                     + ((str(z["exchanges"]),) if slots else ()))
    return shards


def _check_shards(case, shards, world):
    codes = np.concatenate([s[0] for s in shards])
    counts = np.concatenate([s[1] for s in shards])
    assert np.unique(codes).shape[0] == codes.shape[0], "shards overlap"
    order = np.argsort(codes)
    codes, counts = codes[order], counts[order]
    if case.get("skew"):
        keys = torch_mp_worker.skewed_keys(case["n_keys"], world)
        exp = {}
        for r in range(world):
            mine = keys[r::world]
            for part in (mine, mine[::2]):
                for c in keys_to_codes(part.numpy(), 21).tolist():
                    exp[c] = exp.get(c, 0) + 1
        assert dict(zip(codes.tolist(), counts.tolist())) == exp
        assert all(s[0].size == 0 for s in shards[1:]), "a key left rank 0's hash range"
        return
    seqs = torch_mp_worker.case_sequences(case)
    k = case["k"]
    assert dict(zip(unpack_many(codes, k), counts.tolist())) == oracle.count_sequences(seqs, k)
    exp = NumpyEngine().count(streams_from_sequences(seqs), k)
    np.testing.assert_array_equal(codes, exp.codes)
    np.testing.assert_array_equal(counts, exp.counts)
    if "route" in case:
        on = [(s[2] > 0, s[3] > 0) for s in shards if s[2] + s[3]]
        assert on and all(r == ((True, False) if case["route"] == "flat" else (False, True))
                          for r in on)
    if case["name"].startswith("independence"):  # the same table as a world of one
        one = count_sharded(streams_from_sequences(seqs), k, config=_cfg(batch_rows=8))
        np.testing.assert_array_equal(codes, one.codes)
        np.testing.assert_array_equal(counts, one.counts)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    return _spawn(tmp_path_factory.mktemp("gloo2"), 2, MP_CASES)


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    return _spawn(tmp_path_factory.mktemp("gloo4"), 4, MP_CASES)


@pytest.mark.parametrize("case", MP_CASES, ids=[c["name"] for c in MP_CASES])
def test_two_ranks_on_gloo(two_ranks, case):
    _check_shards(case, two_ranks[case["name"]], 2)


@pytest.mark.slow
@pytest.mark.parametrize("case", MP_CASES, ids=[c["name"] for c in MP_CASES])
def test_four_ranks_on_gloo(four_ranks, case):
    _check_shards(case, four_ranks[case["name"]], 4)


@pytest.mark.slow
def test_sharded_all_k_sweep():
    """k = 1..=32 on the sharded path, flat and dense, against the oracle
    (``tests/test_sharded.py``'s sweep)."""
    rng = random.Random(7)
    for alphabet in ("ACGT", "ACGTN"):
        seqs = [oracle.random_dna(rng, rng.randint(0, 120), alphabet) for _ in range(6)]
        streams = streams_from_sequences(seqs)
        for k in range(1, 33):
            got = count_sharded(streams, k, config=_cfg())
            assert _to_dict(got) == oracle.count_sequences(seqs, k), (alphabet, k)
