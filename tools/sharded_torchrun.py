"""The sharded count over a process group, each rank on its GPUs, against the native core.

    torchrun --nproc-per-node R tools/sharded_torchrun.py [--bases N]
        [--devices-per-rank L] [--k 21] [--seed 0] [--out FILE] [--device cpu]

The reads are ``--bases`` bases of 250 bp reads at random positions of
one random genome of 16 Mbases (made from ``--seed``), in PIECES pieces,
piece j from ``--seed`` and j; rank r writes the pieces j with j mod R = r
into its own FASTA. So every world of 1, 2 or 4 ranks counts the same
reads, and most k-mers occur on every rank, so the exchange sums them.
Each rank drives ``--devices-per-rank`` slots (``make_mesh(R * L)``: the
first L of its share of its host's GPUs, or L slots of ``--device``);
without it, ``make_mesh()``'s default, the host's GPUs shared evenly
among the host's ranks. ``--device cpu`` runs gloo on CPU tensors, a
rehearsal. Each rank counts its file with ``count_kmers_sharded_result``
three times, timed (the first builds the kernels and sets up NCCL), with
the launch counters set to 0 and each slot device's peak memory reset
just before each count, and the ``sharded_exchange`` spans and
``shard_sizes`` events collected. Rank 0 then checks that the ranks'
shards are disjoint and that their union equals the native C++ core's
count of all ranks' files together, and prints one JSON line (also
appended to ``--out``): the GPUs, each rank's devices, seconds, launches,
device peaks, exchange seconds, wire, process and sent bytes and shard
sizes. Any failed check raises. ``torchrun --nproc-per-node 2
tools/sharded_torchrun.py --devices-per-rank 2`` on a 4-GPU host drives
2 ranks of 2 cards; ``--nproc-per-node 1 --devices-per-rank 4`` one rank
of every card.
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
from krust_tpu_torch.ops.keys import codes_to_keys  # noqa: E402
from krust_tpu_torch.parallel.mesh import init_distributed, make_mesh  # noqa: E402
from krust_tpu_torch.parallel.sharded import _owner_of  # noqa: E402
from krust_tpu_torch.utils import tracing  # noqa: E402
from krust_tpu_torch.utils.config import EngineConfig  # noqa: E402

GENOME = 16_000_000
#: the read set's pieces: every world of 1, 2 or 4 ranks gets whole pieces
PIECES = 4


def _gpu_line() -> str:
    try:
        return chip_smoke._gpu_line()
    except (OSError, subprocess.CalledProcessError):
        return "no nvidia-smi"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bases", type=int, default=512_000_000)
    ap.add_argument("--devices-per-rank", type=int, default=None)
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
    per_rank = args.devices_per_rank
    mesh = (make_mesh(world * per_rank, device=args.device) if per_rank
            else make_mesh(device=args.device))
    box = [tempfile.mkdtemp() if rank == 0 else None]
    dist.broadcast_object_list(box, src=0)
    work = box[0]
    try:
        genome = np.random.default_rng(args.seed).integers(0, 4, GENOME, dtype=np.uint8)
        path = os.path.join(work, f"reads_{rank}.fa")
        with open(path, "wb") as out:
            for j in range(rank, PIECES, world):
                piece = os.path.join(work, f"piece_{j}.fa")
                chip_smoke.write_reads(piece, np.random.default_rng([args.seed, j]),
                                       args.bases // PIECES, GENOME, genome=genome)
                with open(piece, "rb") as f:
                    shutil.copyfileobj(f, out)
                os.unlink(piece)
        seen: dict = {}

        def collect(kind, name, fields):
            if name in ("sharded_exchange", "shard_sizes"):
                seen.setdefault(name, []).append(fields)

        tracing.add_collector(collect)
        runs = []
        devices = sorted(set(mesh.devices), key=str)
        for _ in range(3):
            seen.clear()
            if cuda:
                torch.cuda.empty_cache()
                for d in devices:
                    torch.cuda.reset_peak_memory_stats(d)
            dist.barrier()
            chip_smoke._zero_launches()
            t0 = time.perf_counter()
            got = count_kmers_sharded_result(path, args.k, mesh=mesh, config=config)
            sec = time.perf_counter() - t0
            launches = chip_smoke._launches()
            needed = ["encode_windows", "rle_compact"] + (
                ["merge_sorted"] if len(mesh.devices) > 1 or world > 1 else [])
            if cuda and min(launches[n] for n in needed) <= 0:
                raise AssertionError(f"rank {rank}: a kernel never launched: {launches}")
            ex = seen["sharded_exchange"]
            runs.append({"seconds": sec, "launches": launches,
                         "peak_device_bytes": {str(d): torch.cuda.max_memory_allocated(d)
                                               for d in devices} if cuda else None,
                         "exchange_s": [e["elapsed_s"] for e in ex],
                         "wire_bytes": [e["wire_bytes"] for e in ex],
                         "process_bytes": [e["process_bytes"] for e in ex],
                         "sent_bytes": [e["sent_bytes"] for e in ex],
                         "shard_sizes": [e["sizes"] for e in seen["shard_sizes"]]})
        tracing.remove_collector(collect)
        np.savez(os.path.join(work, f"shard_{rank}.npz"), codes=got.codes, counts=got.counts)
        with open(os.path.join(work, f"runs_{rank}.json"), "w") as f:
            device = torch.cuda.get_device_name(torch.cuda.current_device()) if cuda else "cpu"
            json.dump({"rank": rank, "device": device,
                       "devices": [str(d) for d in mesh.devices], "runs": runs}, f)
        dist.barrier()
        if rank == 0:
            _check(work, world, args, cuda, len(mesh.devices))
        dist.barrier()
    finally:
        dist.destroy_process_group()
        if rank == 0:
            shutil.rmtree(work, ignore_errors=True)
    return 0


def _check(work, world, args, cuda, slots) -> None:
    shards = [np.load(os.path.join(work, f"shard_{r}.npz")) for r in range(world)]
    for r, s in enumerate(shards):  # a rank holds the keys of its own slots
        keys = torch.from_numpy(codes_to_keys(s["codes"], args.k))
        if not torch.all(_owner_of(keys, world * slots) // slots == r):
            raise AssertionError(f"rank {r} holds a key another rank's slots own")
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
            "bases": args.bases, "genome": GENOME, "devices_per_rank": slots,
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
