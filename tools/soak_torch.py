"""Seeded exactness soak: krust_tpu_torch's device engine against the native core.

The shape of ``benches/soak_tpu.py`` for the port. Each trial draws, from
one seeded generator: k in 1..32, the batch geometry (``block_windows``,
``batch_rows``), the dirt (N density, quality masking at a random
threshold, so both the flat and the dense route run), the epoch size
(``KRUST_EPOCH_ENTRIES``, often small enough to flush and merge), the
ingest (eager, or record-aligned chunks of a random size) and the table
(epoch sort or the LSM ``DeviceTable``). It writes the reads as FASTA or
FASTQ, counts them through ``api._count_path`` on the device engine and
through the native C++ core, and requires the two tables to be equal.

    python3 tools/soak_torch.py [--device cuda|cpu] [--iters N] [--seed S]

On the card (the default) reads are 2-24 Mbases a trial; ``--device cpu``
runs the kernels' plain versions at 10-60 kbases (a test runs it so).
One JSON line a trial, then a summary line; exit 1 at the first
divergence, whose line carries the trial's parameters.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

_ACGT = np.frombuffer(b"ACGT", np.uint8)

#: (block_windows, batch_rows): the default, and narrow rows (at 8 windows
#: a row, k > 9 takes the dense route whatever the dirt)
_CARD_GEOMETRIES = [(4096, 8192), (1024, 1024), (256, 4096), (8, 65536)]
_CPU_GEOMETRIES = [(256, 16), (256, 4), (64, 4), (8, 16)]


def _write_reads(path, rng, n_bases, read_len, genome_len, fastq, n_rate, lowq_rate):
    genome = rng.integers(0, 4, genome_len, dtype=np.uint8)
    n_reads = max(n_bases // read_len, 1)
    starts = rng.integers(0, genome_len - read_len, n_reads)
    seq = _ACGT[genome[starts[:, None] + np.arange(read_len)]]
    if n_rate:
        seq[rng.random(seq.shape) < n_rate] = ord("N")
    soft = rng.random(seq.shape) < 0.02
    seq[soft] += 32
    nl = np.full((n_reads, 1), ord("\n"), np.uint8)
    if fastq:
        qual = np.full(seq.shape, ord("I"), np.uint8)
        qual[rng.random(seq.shape) < lowq_rate] = ord("#")
        head = np.broadcast_to(np.frombuffer(b"@r\n", np.uint8), (n_reads, 3))
        plus = np.broadcast_to(np.frombuffer(b"+\n", np.uint8), (n_reads, 2))
        rec = np.concatenate([head, seq, nl, plus, qual, nl], axis=1)
    else:
        head = np.broadcast_to(np.frombuffer(b">r\n", np.uint8), (n_reads, 3))
        rec = np.concatenate([head, seq, nl], axis=1)
    with open(path, "wb") as f:
        f.write(rec.tobytes())
    return n_reads * read_len


def trial(rng, device: str, tmp: str) -> dict:
    """One randomized count on the device engine against the native core."""
    from krust_tpu_torch import api
    from krust_tpu_torch.io.format import SequenceFormat
    from krust_tpu_torch.io.reader import parse_to_streams, read_input_bytes
    from krust_tpu_torch.models.engines import NativeEngine
    from krust_tpu_torch.utils.config import EngineConfig

    small = device == "cpu"
    k = int(rng.integers(1, 33))
    geometries = _CPU_GEOMETRIES if small else _CARD_GEOMETRIES
    block_windows, batch_rows = geometries[int(rng.integers(0, len(geometries)))]
    n_bases = int(rng.integers(10, 61) * 1000 if small else rng.integers(2, 25) * 1_000_000)
    read_len = int(rng.choice([80, 250, 1000]))
    coverage = int(rng.choice([1, 8, 32]))
    n_rate = float(rng.choice([0.0, 0.0005, 0.01, 0.08]))
    fastq = bool(rng.integers(0, 2))
    lowq_rate = float(rng.choice([0.0, 0.01, 0.05])) if fastq else 0.0
    min_quality = int(rng.integers(0, 41)) if fastq and rng.integers(0, 2) else None
    epoch = int(rng.choice([0, 1 << 12, 1 << 16])) if small else int(
        rng.choice([0, 1 << 22, 1 << 24]))
    chunk = int(rng.choice([0, 700, 1 << 16])) if small else int(
        rng.choice([0, 1 << 20, 16 << 20]))
    lsm = bool(rng.integers(0, 2))
    params = dict(k=k, block_windows=block_windows, batch_rows=batch_rows, n_bases=n_bases,
                  read_len=read_len, coverage=coverage, n_rate=n_rate, fastq=fastq,
                  lowq_rate=lowq_rate, min_quality=min_quality, epoch_entries=epoch or None,
                  chunk_bytes=chunk or None, table="lsm" if lsm else "epoch")

    path = os.path.join(tmp, "soak.fq" if fastq else "soak.fa")
    genome_len = max(n_bases // coverage, read_len + 1)
    _write_reads(path, rng, n_bases, read_len, genome_len, fastq, n_rate, lowq_rate)
    cfg = EngineConfig(block_windows=block_windows, batch_rows=batch_rows, device=device,
                       ingest_chunk_bytes=chunk or None, use_epoch_sort=not lsm)
    if epoch:
        os.environ["KRUST_EPOCH_ENTRIES"] = str(epoch)
    try:
        t0 = time.perf_counter()
        got = api._count_path(path, k, min_quality=min_quality, config=cfg)
        device_s = time.perf_counter() - t0
    finally:
        os.environ.pop("KRUST_EPOCH_ENTRIES", None)
    streams = parse_to_streams(read_input_bytes(path), SequenceFormat.AUTO.resolve(path))
    exp = NativeEngine().count(streams, k, min_quality)
    ok = bool(np.array_equal(got.codes, exp.codes) and np.array_equal(got.counts, exp.counts))
    return dict(params, distinct=exp.distinct, device_s=device_s, equal=ok)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args()

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("soak_torch: no CUDA device (pass --device cpu for the plain versions)",
              file=sys.stderr)
        return 2
    gpu = None
    if args.device == "cuda":
        gpu = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    rng = np.random.default_rng(args.seed)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        for i in range(args.iters):
            row = trial(rng, args.device, tmp)
            print(json.dumps({"trial": i, **row}), flush=True)
            if not row["equal"]:
                print(json.dumps({"soak": "diverged", "seed": args.seed, "trial": i}))
                return 1
    print(json.dumps({"soak": "passed", "trials": args.iters, "seed": args.seed,
                      "device": args.device, "gpu": gpu,
                      "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
