"""The sharded count on several GPUs, one process per GPU, against the native core.

    torchrun --nproc-per-node 4 tools/sharded_torchrun.py [--bases-per-rank N]
        [--k 21] [--seed 0] [--out FILE] [--device cpu]

Every rank writes its own FASTA of 250 bp reads (``--bases-per-rank``
bases) at random positions of one random genome of 16 Mbases, the same on
every rank (made from ``--seed``; each rank's reads from ``--seed`` and
its rank), so most k-mers occur on every rank and the exchange sums them.
Each rank counts its file with ``count_kmers_sharded_result`` (NCCL, one
GPU per rank; ``--device cpu`` runs gloo on CPU tensors, a rehearsal)
three times, timed (the first builds the kernels and sets up NCCL), with
the launch counters set to 0 just before each count and the
``sharded_exchange`` spans and ``shard_sizes`` events collected. Rank 0
then checks that the ranks' shards are disjoint and that their union
equals the native C++ core's count of all ranks' files together, and
prints one JSON line (also appended to ``--out``): the GPUs, each rank's
seconds, launches, exchange seconds, wire bytes and shard sizes. Any
failed check raises. ``--nproc-per-node 1`` with four times the bases is
the one-GPU count of as much input.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (write_reads, the native core, the counters)
from krust_tpu_torch.api import count_kmers_sharded_result  # noqa: E402
from krust_tpu_torch.parallel.mesh import init_distributed  # noqa: E402
from krust_tpu_torch.utils import tracing  # noqa: E402
from krust_tpu_torch.utils.config import EngineConfig  # noqa: E402

GENOME = 16_000_000


def _gpu_line() -> str:
    try:
        return chip_smoke._gpu_line()
    except (OSError, subprocess.CalledProcessError):
        return "no nvidia-smi"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bases-per-rank", type=int, default=128_000_000)
    ap.add_argument("--k", type=int, default=21)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default=None, help="cpu: a gloo rehearsal")
    args = ap.parse_args()

    init_distributed(backend="gloo" if args.device == "cpu" else None,
                     timeout=timedelta(minutes=5))
    rank, world = dist.get_rank(), dist.get_world_size()
    cuda = args.device != "cpu"
    config = EngineConfig(device=args.device) if args.device else None
    box = [tempfile.mkdtemp() if rank == 0 else None]
    dist.broadcast_object_list(box, src=0)
    work = box[0]
    try:
        genome = np.random.default_rng(args.seed).integers(0, 4, GENOME, dtype=np.uint8)
        path = os.path.join(work, f"reads_{rank}.fa")
        chip_smoke.write_reads(path, np.random.default_rng([args.seed, rank]),
                               args.bases_per_rank, GENOME, genome=genome)
        seen: dict = {}

        def collect(kind, name, fields):
            if name in ("sharded_exchange", "shard_sizes"):
                seen.setdefault(name, []).append(fields)

        tracing.add_collector(collect)
        runs = []
        for _ in range(3):
            seen.clear()
            dist.barrier()
            chip_smoke._zero_launches()
            t0 = time.perf_counter()
            got = count_kmers_sharded_result(path, args.k, config=config)
            sec = time.perf_counter() - t0
            launches = chip_smoke._launches()
            if cuda and (launches["encode_windows"] <= 0 or launches["rle_compact"] <= 0):
                raise AssertionError(f"rank {rank}: a kernel never launched: {launches}")
            runs.append({"seconds": sec, "launches": launches,
                         "wire_bytes": [e["wire_bytes"] for e in seen["sharded_exchange"]],
                         "exchange_s": [e["elapsed_s"] for e in seen["sharded_exchange"]],
                         "shard_sizes": [e["sizes"] for e in seen["shard_sizes"]]})
        tracing.remove_collector(collect)
        np.savez(os.path.join(work, f"shard_{rank}.npz"), codes=got.codes, counts=got.counts)
        with open(os.path.join(work, f"runs_{rank}.json"), "w") as f:
            device = torch.cuda.get_device_name(torch.cuda.current_device()) if cuda else "cpu"
            json.dump({"rank": rank, "device": device, "runs": runs}, f)
        dist.barrier()
        if rank == 0:
            _check(work, world, args, cuda)
        dist.barrier()
    finally:
        dist.destroy_process_group()
        if rank == 0:
            shutil.rmtree(work, ignore_errors=True)
    return 0


def _check(work, world, args, cuda) -> None:
    shards = [np.load(os.path.join(work, f"shard_{r}.npz")) for r in range(world)]
    codes = np.concatenate([s["codes"] for s in shards])
    counts = np.concatenate([s["counts"] for s in shards])
    if np.unique(codes).shape[0] != codes.shape[0]:
        raise AssertionError("shards overlap")
    order = np.argsort(codes)
    every = os.path.join(work, "all.fa")
    with open(every, "wb") as out:
        for r in range(world):
            with open(os.path.join(work, f"reads_{r}.fa"), "rb") as f:
                shutil.copyfileobj(f, out)
    t0 = time.perf_counter()
    exp = chip_smoke._native_counts(every, args.k)
    native_s = time.perf_counter() - t0
    if not (np.array_equal(codes[order], exp.codes)
            and np.array_equal(counts[order], exp.counts)):
        raise AssertionError(f"union of {world} shards != native core "
                             f"({codes.shape[0]} vs {exp.distinct} distinct)")
    ranks = []
    for r in range(world):
        with open(os.path.join(work, f"runs_{r}.json")) as f:
            ranks.append(json.load(f))
    line = {"tool": "sharded_torchrun", "world": world, "k": args.k,
            "bases_per_rank": args.bases_per_rank, "genome": GENOME,
            "distinct": exp.distinct, "total": exp.total,
            "shards": [int(s["codes"].shape[0]) for s in shards],
            "union_equal_to_native": True, "native_core_s": native_s,
            "gpu": _gpu_line() if cuda else "cpu", "ranks": ranks}
    print(json.dumps(line), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "a") as f:
            f.write(json.dumps(line) + "\n")


if __name__ == "__main__":
    sys.exit(main())
