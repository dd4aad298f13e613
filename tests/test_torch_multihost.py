"""Ranks that each drive several slots: the port's counterpart of
``tests/test_multihost.py`` (2 processes of 4 devices each).

Two gloo ranks, each in its own process (``tests/torch_mp_worker.py`` with
a slots-per-rank argument), each driving 2 and then 4 CPU slots: the
inputs of ``test_multihost.py`` (``random.Random(1234)``, 40 records, k = 5
over ``ACGTN`` on the dense route, k = 21 over ``ACGT`` on the flat one)
and the unequal, skew and window-limit cases of
``tests/test_torch_sharded.py``'s ``MP_CASES``. The ranks' tables must be
disjoint, each rank's keys owned by its own global slots, their union
equal to the oracle and to ``krust_tpu``'s count of all records on its
8-device XLA-CPU mesh; each exchange merges with K3 and K2 and calls no
``merge_runs``. Two ranks of 3 slots each hold, rank by rank, the entries
of ``krust_tpu``'s table whose ``krust_tpu`` owner among 6 chips is one of
the rank's global slots. In one process, the exchange of several slots
sends nothing between processes. Integer work: tables equal exactly.
"""

import json
import random

import jax
import numpy as np
import pytest
import torch

from krust_tpu.io.reader import streams_from_sequences as jax_streams
from krust_tpu.parallel.mesh import make_mesh as jax_make_mesh
from krust_tpu.parallel.sharded import _owner_of as jax_owner_of
from krust_tpu.parallel.sharded import count_sharded as jax_count_sharded
from krust_tpu.utils.config import EngineConfig as JaxConfig
from krust_tpu_torch.io.reader import streams_from_sequences
from krust_tpu_torch.kmer import unpack_many
from krust_tpu_torch.ops.keys import codes_to_keys, keys_to_codes
from krust_tpu_torch.parallel.mesh import init_distributed, make_mesh
from krust_tpu_torch.parallel.sharded import _owner_of, count_sharded
from krust_tpu_torch.utils import tracing
from krust_tpu_torch.utils.config import EngineConfig

import oracle
import torch_mp_worker
from test_torch_sharded import MP_CASES, _spawn

WORLD = 2
#: test_multihost.py's two inputs, then MP_CASES' unequal, skew and
#: window-limit cases (the unequal ones carry the window limit)
CASES = [
    {"name": "multihost_k5", "k": 5, "alphabet": "ACGTN", "route": "dense"},
    {"name": "multihost_k21", "k": 21, "alphabet": "ACGT", "route": "flat"},
] + [c for c in MP_CASES if c.get("unequal") or c.get("skew")]
for _c in CASES:
    _c.setdefault("seed", 1234)
    _c.setdefault("n_seqs", 40)
    _c.setdefault("max_len", 300)

SLOTS = [2, 4]
PARAMS = [(s, c) for s in SLOTS for c in CASES]


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches():
    yield
    jax.clear_caches()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{slots: {case name: [(codes, counts, flat, dense, exchanges) of each
    rank]}}, one spawn of the two ranks per slot count."""
    return {slots: _spawn(tmp_path_factory.mktemp(f"slots{slots}"), WORLD,
                          CASES + [{"name": "mismatch", "mismatch": True}], slots)
            for slots in SLOTS}


_JAX_TABLES: dict = {}


def _jax_table(case):
    """``krust_tpu``'s count of every record of a sequence case."""
    if case["name"] not in _JAX_TABLES:
        seqs = torch_mp_worker.case_sequences(case)
        _JAX_TABLES[case["name"]] = jax_count_sharded(
            jax_streams(seqs), case["k"], mesh=jax_make_mesh(8),
            config=JaxConfig(block_windows=128, batch_rows=16))
    return _JAX_TABLES[case["name"]]


@pytest.mark.parametrize("slots,case", PARAMS,
                         ids=[f"{s}slots-{c['name']}" for s, c in PARAMS])
def test_two_ranks_of_several_slots_on_gloo(ranks, slots, case):
    shards = ranks[slots][case["name"]]
    k = case.get("k", 21)
    n_slots = WORLD * slots
    for r, (codes, *_rest) in enumerate(shards):  # a rank holds its own slots' keys
        owner = _owner_of(torch.from_numpy(codes_to_keys(codes, k)), n_slots)
        assert torch.all(owner // slots == r), f"rank {r} holds another rank's key"
    codes = np.concatenate([s[0] for s in shards])
    counts = np.concatenate([s[1] for s in shards])
    assert np.unique(codes).shape[0] == codes.shape[0], "shards overlap"
    order = np.argsort(codes)
    codes, counts = codes[order], counts[order]
    exchanges = [e for s in shards for e in json.loads(str(s[4]))]
    assert exchanges and all(e["merge_runs"] == 0 for e in exchanges)
    # every destination that received entries merged them with K2, once
    assert all(e["k2"] == sum(n > 0 for n in e["sizes"]) for e in exchanges)
    assert sum(e["k3"] for e in exchanges) > 0
    assert all(len(e["sizes"]) == slots for e in exchanges)
    assert sum(e["process_bytes"] for e in exchanges) > 0
    if case.get("skew"):
        keys = torch_mp_worker.skewed_keys(case["n_keys"], n_slots)
        exp = {}
        for r in range(WORLD):
            for batch in torch_mp_worker.skew_batches(keys, r, WORLD, slots):
                for c in keys_to_codes(batch.numpy(), 21).tolist():
                    exp[c] = exp.get(c, 0) + 1
        assert dict(zip(codes.tolist(), counts.tolist())) == exp
        assert shards[1][0].size == 0, "a key left the first slot's hash range"
        return
    seqs = torch_mp_worker.case_sequences(case)
    assert dict(zip(unpack_many(codes, k), counts.tolist())) == oracle.count_sequences(seqs, k)
    exp = _jax_table(case)
    np.testing.assert_array_equal(codes, exp.codes)
    np.testing.assert_array_equal(counts, exp.counts)
    if "route" in case:
        on = [(s[2] > 0, s[3] > 0) for s in shards if s[2] + s[3]]
        assert on and all(r == ((True, False) if case["route"] == "flat" else (False, True))
                          for r in on)
    if case.get("window_limit"):  # the limit forces exchanges while rank 1 runs dry
        assert min(len(json.loads(str(s[4]))) for s in shards) >= 2


#: test_multihost.py's two inputs on 2 ranks of 3 slots: 6 slots, an n
#: that does not divide 4
THREE = [c for c in CASES if c["name"].startswith("multihost")]


@pytest.fixture(scope="module")
def three_slot_ranks(tmp_path_factory):
    """{case name: [(codes, counts, flat, dense, exchanges) of each rank]}
    of the two ranks of 3 slots, one spawn."""
    return _spawn(tmp_path_factory.mktemp("slots3"), WORLD, THREE, 3)


@pytest.mark.parametrize("case", THREE, ids=[c["name"] for c in THREE])
def test_two_ranks_of_three_slots_hold_jax_owners(three_slot_ranks, case):
    """Rank r's table is ``krust_tpu``'s table cut to the keys whose
    ``krust_tpu`` owner among 6 chips is one of rank r's global slots, 3r
    .. 3r + 2: each rank returns what ``krust_tpu``'s process of those
    chips returns."""
    exp = _jax_table(case)
    hi = (exp.codes >> np.uint64(32)).astype(np.uint32)
    owner = np.asarray(jax_owner_of(hi, exp.codes.astype(np.uint32), WORLD * 3))
    for r, (codes, counts, *_rest) in enumerate(three_slot_ranks[case["name"]]):
        mine = owner // 3 == r
        order = np.argsort(codes)
        np.testing.assert_array_equal(codes[order], exp.codes[mine])
        np.testing.assert_array_equal(counts[order], exp.counts[mine])
        assert mine.any()


def test_ranks_of_unequal_slots_raise_alike(ranks):
    """Rank r asks for r + 1 slots: every rank raises the same error."""
    said = [json.loads(str(s[4]))[0]["error"] for s in ranks[SLOTS[0]]["mismatch"]]
    assert said[0] == said[1]
    assert "would drive [1, 2] devices" in said[0]


@pytest.fixture
def exchanges():
    seen = []

    def collect(kind, name, fields):
        if name == "sharded_exchange":
            seen.append(fields)

    tracing.add_collector(collect)
    yield seen
    tracing.remove_collector(collect)


@pytest.mark.parametrize("group", [False, True], ids=["no-group", "one-rank-gloo"])
def test_a_world_of_one_sends_nothing_between_processes(tmp_path, exchanges, group):
    """Three CPU slots in one process, with and without a one-rank group:
    entries are sent, none crosses a device or a process."""
    rng = random.Random(1234)
    seqs = [oracle.random_dna(rng, rng.randint(0, 300), "ACGTN") for _ in range(40)]
    if group:
        init_distributed(f"file://{tmp_path / 'pg'}", rank=0, world_size=1, backend="gloo")
    try:
        mesh = make_mesh(devices=["cpu"] * 3)
        got = count_sharded(streams_from_sequences(seqs), 5, mesh=mesh,
                            config=EngineConfig(device="cpu", block_windows=128, batch_rows=8))
    finally:
        if group:
            torch.distributed.destroy_process_group()
    assert (mesh.group is not None) == group and (mesh.size, mesh.world) == (3, 1)
    assert got.to_string_dict() == oracle.count_sequences(seqs, 5)
    (ex,) = exchanges
    assert ex["sent_bytes"] >= 8 * got.distinct > 0  # a key of several slots, once each
    assert ex["process_bytes"] == ex["wire_bytes"] == 0
