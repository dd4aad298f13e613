"""One rank of a multi-process ``krust_tpu_torch`` sharded count on gloo
(spawned by ``tests/test_torch_sharded.py`` and
``tests/test_torch_multihost.py``; the port's counterpart of
``tests/mp_worker.py``).

    python tests/torch_mp_worker.py RANK WORLD INIT_FILE OUTDIR CASES_JSON [SLOTS]

Joins a ``world``-rank gloo group through ``file://INIT_FILE``, then runs
every case in turn on CPU tensors and writes this rank's hash-range shard
of each, with its codec calls by route, to ``OUTDIR/<case>_<rank>.npz``.
With SLOTS, each rank drives a mesh of SLOTS CPU slots (``make_mesh(
devices=["cpu"] * SLOTS)``) and also writes what its exchanges did: the
K2 and K3 calls and the ``merge_runs`` calls inside each, each one's
``shard_sizes`` and ``process_bytes``. A sequence case counts only this
rank's records (:func:`local_sequences`: ``seqs[rank::world]``, or an
unequal split where rank 0 holds all but one record per other rank, so the
others run dry first); a ``skew`` case exchanges a table whose keys all
hash to the mesh's first slot; a ``mismatch`` case asks for a mesh of
rank + 1 slots and writes the error every rank must raise. The parent holds the union of the shards
against the oracle. Each count must scan its input at most once.
"""

import json
import os
import random
import sys
from datetime import timedelta

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def case_sequences(case):
    """Every record of a sequence case, from its seed."""
    import oracle

    rng = random.Random(case["seed"])
    return [
        oracle.random_dna(rng, rng.randint(0, case["max_len"]), case["alphabet"])
        for _ in range(case["n_seqs"])
    ]


def local_sequences(case, rank, world):
    seqs = case_sequences(case)
    if not case.get("unequal"):
        return seqs[rank::world]
    cut = len(seqs) - (world - 1)
    return seqs[:cut] if rank == 0 else [seqs[cut + rank - 1]]


def skewed_keys(n_keys, world, seed=9):
    """``n_keys`` distinct k = 21 keys (int64, biased) that all hash to
    rank 0 of ``world``."""
    import torch

    from krust_tpu_torch.parallel.sharded import _owner_of

    g = torch.Generator().manual_seed(seed)
    keys = torch.empty(0, dtype=torch.int64)
    while keys.numel() < n_keys:
        cand = torch.randint(0, 1 << 42, (4 * n_keys,), generator=g) - (1 << 63)
        keys = torch.unique(torch.cat([keys, cand[_owner_of(cand, world) == 0]]))
    return keys[:n_keys]


def skew_batches(keys, rank, world, slots):
    """The key batches rank ``rank`` adds to its slots in a skew case: its
    keys (``keys[rank::world]``) in one part a slot, each followed by every
    other key of the part again (counts 1 and 2)."""
    import torch

    return [torch.cat([c, c[::2]]) for c in keys[rank::world].chunk(slots)]


def _run_sequence_case(case, rank, world, slots=None):
    """This rank's shard, and its codec calls by route (flat K1, dense K4)."""
    from krust_tpu_torch.io import native
    from krust_tpu_torch.io.reader import streams_from_sequences
    from krust_tpu_torch.ops import codec, fused_codec
    from krust_tpu_torch.ops import table as table_mod
    from krust_tpu_torch.parallel.mesh import make_mesh
    from krust_tpu_torch.parallel.sharded import count_sharded
    from krust_tpu_torch.utils.config import EngineConfig

    streams = streams_from_sequences(local_sequences(case, rank, world))
    scans = {"n": 0}
    real_scan = native.scan_pack_native

    def spy(*a, **kw):
        scans["n"] += 1
        return real_scan(*a, **kw)

    calls = {"flat": 0, "dense": 0}
    real = {"flat": fused_codec.encode_windows, "dense": codec.encode_dense}

    def counted(route):
        def call(*a):
            calls[route] += 1
            return real[route](*a)
        return call

    limit = table_mod.EPOCH_WINDOW_LIMIT
    native.scan_pack_native = spy
    fused_codec.encode_windows, codec.encode_dense = counted("flat"), counted("dense")
    if case.get("window_limit"):
        table_mod.EPOCH_WINDOW_LIMIT = case["window_limit"]
    try:
        cfg = EngineConfig(block_windows=case.get("block_windows", 128), batch_rows=8,
                           device="cpu", use_epoch_sort=case.get("epoch_sort", True))
        mesh = make_mesh(devices=["cpu"] * slots) if slots else None
        result = count_sharded(streams, case["k"], mesh=mesh, config=cfg)
    finally:
        native.scan_pack_native = real_scan
        fused_codec.encode_windows, codec.encode_dense = real["flat"], real["dense"]
        table_mod.EPOCH_WINDOW_LIMIT = limit
    if scans["n"] > 1:
        raise AssertionError(f"{case['name']}: input scanned {scans['n']} times")
    return result.codes, result.counts, calls


def _run_skew_case(case, rank, world):
    """Half of the skewed keys on each rank, counts 1 and 2: the exchange
    sends every entry to rank 0."""
    import torch

    from krust_tpu_torch.ops.keys import keys_to_codes
    from krust_tpu_torch.parallel.mesh import make_mesh
    from krust_tpu_torch.parallel.sharded import EpochShardedTable, ShardedTable

    keys = skewed_keys(case["n_keys"], world)
    mine = keys[rank::world]
    mesh = make_mesh(world, device="cpu")
    if case.get("epoch_sort", True):
        table = EpochShardedTable(21, mesh)
        table.add(torch.cat([mine, mine[::2]]), 2 * mine.numel())
    else:
        table = ShardedTable(21, mesh)
        table.add(mine, torch.ones_like(mine, dtype=torch.int32), mine.numel())
        table.add(mine[::2], None, mine.numel())
    o_keys, o_cnt, n = table.exchange()
    codes = keys_to_codes(o_keys[:n].numpy(), 21)
    return codes, o_cnt[:n].numpy().astype(np.uint64), {"flat": 0, "dense": 0}


def _run_skew_slots_case(case, rank, world, slots):
    """:func:`skew_batches` on this rank's slots, one batch a slot, then
    the slots' exchange and gather: every entry goes to the mesh's first
    slot."""
    import torch

    from krust_tpu_torch.parallel.mesh import make_mesh
    from krust_tpu_torch.parallel.sharded import EpochShardedTable, ShardedTable, _Slots

    epoch = case.get("epoch_sort", True)
    mesh = make_mesh(devices=["cpu"] * slots)
    table = _Slots(21, mesh, EpochShardedTable if epoch else ShardedTable)
    for keys in skew_batches(skewed_keys(case["n_keys"], world * slots), rank, world, slots):
        weights = () if epoch else (torch.ones_like(keys, dtype=torch.int32),)
        table.add(keys, *weights, keys.numel())
    codes, counts = table.finalize()
    return codes, counts, {"flat": 0, "dense": 0}


def _mismatch_error(rank):
    """What ``make_mesh`` raises when rank r asks for r + 1 slots: the
    message, written for the parent to hold every rank's equal."""
    from krust_tpu_torch.parallel.mesh import make_mesh

    try:
        make_mesh(devices=["cpu"] * (rank + 1))
    except ValueError as e:
        return str(e)
    raise AssertionError("ranks of unequal slots built a mesh")


def _exchange_spy():
    """Records, for each exchange this process runs, the K2 and K3 calls
    and the ``merge_runs`` calls it made, its ``shard_sizes`` and its
    ``process_bytes``. Returns the records and a function that undoes the
    spy."""
    from krust_tpu_torch.ops import count as count_mod
    from krust_tpu_torch.ops import table as table_mod
    from krust_tpu_torch.parallel import sharded
    from krust_tpu_torch.utils import tracing

    calls = {"k2": 0, "k3": 0, "merge_runs": 0}
    real = {"k2": sharded.rle_compact, "k3": sharded.merge_sorted,
            "merge_runs": count_mod.merge_runs, "exchange": sharded._exchange}

    def counted(name):
        def call(*a, **kw):
            calls[name] += 1
            return real[name](*a, **kw)
        return call

    records, fields = [], {}

    def collect(kind, name, f):
        if name in ("sharded_exchange", "shard_sizes"):
            fields[name] = f

    def exchange(*a, **kw):
        before = dict(calls)
        fields.clear()
        shards = real["exchange"](*a, **kw)
        records.append({**{n: calls[n] - before[n] for n in calls},
                        "sizes": fields["shard_sizes"]["sizes"],
                        "process_bytes": fields.get("sharded_exchange", {}).get(
                            "process_bytes", 0)})
        return shards

    sharded.rle_compact, sharded.merge_sorted = counted("k2"), counted("k3")
    count_mod.merge_runs = table_mod.merge_runs = counted("merge_runs")
    sharded._exchange = exchange
    tracing.add_collector(collect)

    def undo():
        tracing.remove_collector(collect)
        sharded.rle_compact, sharded.merge_sorted = real["k2"], real["k3"]
        count_mod.merge_runs = table_mod.merge_runs = real["merge_runs"]
        sharded._exchange = real["exchange"]

    return records, undo


def main():
    rank, world = int(sys.argv[1]), int(sys.argv[2])
    init_file, outdir, cases = sys.argv[3], sys.argv[4], json.loads(sys.argv[5])
    slots = int(sys.argv[6]) if len(sys.argv) > 6 else None
    sys.path.insert(0, HERE)
    sys.path.insert(0, os.path.dirname(HERE))  # the repo root: krust_tpu_torch

    import torch.distributed as dist

    from krust_tpu_torch.parallel.mesh import init_distributed

    init_distributed(f"file://{init_file}", rank=rank, world_size=world, backend="gloo",
                     timeout=timedelta(seconds=120))
    try:
        for case in cases:
            if not slots:
                run = _run_skew_case if case.get("skew") else _run_sequence_case
                codes, counts, calls = run(case, rank, world)
                np.savez(os.path.join(outdir, f"{case['name']}_{rank}.npz"),
                         codes=codes, counts=counts, **calls)
                continue
            if case.get("mismatch"):
                np.savez(os.path.join(outdir, f"{case['name']}_{rank}.npz"),
                         codes=np.zeros(0, np.uint64), counts=np.zeros(0, np.uint64), flat=0,
                         dense=0, exchanges=json.dumps([{"error": _mismatch_error(rank)}]))
                continue
            run = _run_skew_slots_case if case.get("skew") else _run_sequence_case
            records, undo = _exchange_spy()
            try:
                codes, counts, calls = run(case, rank, world, slots)
            finally:
                undo()
            np.savez(os.path.join(outdir, f"{case['name']}_{rank}.npz"),
                     codes=codes, counts=counts, exchanges=json.dumps(records), **calls)
    finally:
        dist.destroy_process_group()
    print(f"rank {rank}: {len(cases)} cases", flush=True)


if __name__ == "__main__":
    main()
