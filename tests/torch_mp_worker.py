"""One rank of a multi-process ``krust_tpu_torch`` sharded count on gloo
(spawned by ``tests/test_torch_sharded.py``; the port's counterpart of
``tests/mp_worker.py``).

    python tests/torch_mp_worker.py RANK WORLD INIT_FILE OUTDIR CASES_JSON

Joins a ``world``-rank gloo group through ``file://INIT_FILE``, then runs
every case in turn on CPU tensors and writes this rank's hash-range shard
of each, with its codec calls by route, to ``OUTDIR/<case>_<rank>.npz``.
A sequence case counts only this
rank's records (:func:`local_sequences`: ``seqs[rank::world]``, or an
unequal split where rank 0 holds all but one record per other rank, so the
others run dry first); a ``skew`` case exchanges a table whose keys all
hash to rank 0. The parent holds the union of the shards against the
oracle. Each count must scan its input at most once.
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


def _run_sequence_case(case, rank, world):
    """This rank's shard, and its codec calls by route (flat K1, dense K4)."""
    from krust_tpu_torch.io import native
    from krust_tpu_torch.io.reader import streams_from_sequences
    from krust_tpu_torch.ops import codec, fused_codec
    from krust_tpu_torch.ops import table as table_mod
    from krust_tpu_torch.parallel.sharded import count_sharded
    from krust_tpu_torch.utils.config import EngineConfig

    streams = streams_from_sequences(local_sequences(case, rank, world))
    scans = {"n": 0}
    real_scan = native.scan_stream_native

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
    native.scan_stream_native = spy
    fused_codec.encode_windows, codec.encode_dense = counted("flat"), counted("dense")
    if case.get("window_limit"):
        table_mod.EPOCH_WINDOW_LIMIT = case["window_limit"]
    try:
        cfg = EngineConfig(block_windows=case.get("block_windows", 128), batch_rows=8,
                           device="cpu", use_epoch_sort=case.get("epoch_sort", True))
        result = count_sharded(streams, case["k"], config=cfg)
    finally:
        native.scan_stream_native = real_scan
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


def main():
    rank, world = int(sys.argv[1]), int(sys.argv[2])
    init_file, outdir, cases = sys.argv[3], sys.argv[4], json.loads(sys.argv[5])
    sys.path.insert(0, HERE)
    sys.path.insert(0, os.path.dirname(HERE))  # the repo root: krust_tpu_torch

    import torch.distributed as dist

    from krust_tpu_torch.parallel.mesh import init_distributed

    init_distributed(f"file://{init_file}", rank=rank, world_size=world, backend="gloo",
                     timeout=timedelta(seconds=120))
    try:
        for case in cases:
            run = _run_skew_case if case.get("skew") else _run_sequence_case
            codes, counts, calls = run(case, rank, world)
            np.savez(os.path.join(outdir, f"{case['name']}_{rank}.npz"),
                     codes=codes, counts=counts, **calls)
    finally:
        dist.destroy_process_group()
    print(f"rank {rank}: {len(cases)} cases", flush=True)


if __name__ == "__main__":
    main()
