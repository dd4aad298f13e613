"""One process counting one input over 1, 2 and 4 GPUs, against the native core.

    python3 tools/sharded_local.py [--cards 1,2,4] [--inputs reads,genome]
        [--reads-bases 512000000] [--genome-bases N] [--seed 0] [--out FILE]
        [--device cpu]

Writes two inputs from ``--seed`` with chip_smoke.py's writers: chip_smoke.py
phase 3's read set (``--reads-bases`` of 250 bp reads at 32x over a 16
Mbase genome, FASTA), counted at k = 21, and config 3's genome-shaped
FASTA (GRCh38's 3.1 Gbases in 24 chromosomes, half soft-masked, 1% N
runs), counted at k = 31, cut by chip_smoke.py phase 10's rule: what the
host's MemTotal holds at 37.6 B a base with 20% to spare, never below 2.3
Gbases (``--genome-bases`` overrides). Each input is counted once by the
native C++ core, then by ``count_kmers_sharded_result`` in this process
over a mesh of the first n cards for each n of ``--cards``, and each table
must equal the native core's. Each input prints a JSON line (its size,
the native core's seconds), then every count one: its seconds, the launch
counts (set to 0 just before), each exchange's seconds, ``wire_bytes``
(what crossed between cards) and shard sizes, the device peak of every
card, the host's resident memory before the count and its peak during it
(``VmRSS`` sampled every 50 ms) and each card's busy share
(``nvidia-smi`` ``utilization.gpu`` sampled every 100 ms; the idle share
is 1 - busy). Then ``krust_tpu_torch.entry.dryrun_multichip`` over the
most cards. Each line is also appended to ``--out`` as it comes. Any
failed check raises.

``--device cpu`` runs the same on n CPU slots (the kernels' plain
versions, no device metrics): a rehearsal at small ``--reads-bases`` and
``--genome-bases``.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (the writers, the native core, the counters)
from krust_tpu_torch.api import count_kmers_sharded_result  # noqa: E402
from krust_tpu_torch.entry import dryrun_multichip  # noqa: E402
from krust_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from krust_tpu_torch.utils import tracing  # noqa: E402


def _rss() -> int:
    """This process's resident bytes (``VmRSS``)."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) * 1024
    return 0


class _Sampler:
    """Peak ``VmRSS`` every 50 ms and, on CUDA, every card's
    ``utilization.gpu`` every 100 ms (an ``nvidia-smi`` child, stopped on
    exit), while the ``with`` block runs."""

    def __init__(self, cuda: bool):
        self._cuda = cuda
        self._stop = threading.Event()
        self.peak_rss = 0
        self._smi = None

    def _watch(self) -> None:
        while not self._stop.is_set():
            self.peak_rss = max(self.peak_rss, _rss())
            self._stop.wait(0.05)

    def __enter__(self) -> "_Sampler":
        self.peak_rss = _rss()
        self._thread = threading.Thread(target=self._watch, daemon=True)
        self._thread.start()
        if self._cuda:
            self._smi = subprocess.Popen(
                ["nvidia-smi", "--query-gpu=index,utilization.gpu",
                 "--format=csv,noheader,nounits", "-lms", "100"],
                stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        return self

    def __exit__(self, *exc) -> None:
        self._stop.set()
        self._thread.join()
        self.busy = {}
        if self._smi is not None:
            self._smi.terminate()
            out, _ = self._smi.communicate()
            samples: dict = {}
            for line in out.splitlines():
                parts = [p.strip() for p in line.split(",")]
                if len(parts) == 2 and parts[0].isdigit() and parts[1].isdigit():
                    samples.setdefault(int(parts[0]), []).append(int(parts[1]))
            self.busy = {i: {"samples": len(v), "busy_share": sum(v) / len(v) / 100}
                         for i, v in sorted(samples.items())}


def _count(path, k, n, cuda, exp, seen) -> dict:
    """One count of ``path`` over the first n cards (or n CPU slots),
    held against ``exp``; its JSON row."""
    mesh = make_mesh(n) if cuda else make_mesh(devices=["cpu"] * n)
    seen.clear()
    if cuda:
        torch.cuda.empty_cache()
        for d in mesh.devices:
            torch.cuda.reset_peak_memory_stats(d)
    chip_smoke._zero_launches()
    rss_before = _rss()
    with _Sampler(cuda) as sampler:
        t0 = time.perf_counter()
        got = count_kmers_sharded_result(path, k, mesh=mesh)
        sec = time.perf_counter() - t0
    launches = chip_smoke._launches()
    tag = f"{os.path.basename(path)} k={k} on {n}"
    chip_smoke._assert_equal(got, exp, tag)
    # K1 and K2 on every count; K3 in every exchange of several cards
    path_kernels = ("encode_windows", "rle_compact") + (("merge_sorted",) if n > 1 else ())
    if cuda and min(launches[name] for name in path_kernels) <= 0:
        raise AssertionError(f"{tag}: a kernel of the path did not launch: {launches}")
    exchanges = seen.get("sharded_exchange", [])
    return {"cards": n, "devices": [str(d) for d in mesh.devices], "seconds": sec,
            "distinct": got.distinct, "equal_to_native": True, "launches": launches,
            "exchanges": len(exchanges),
            "exchange_s": [e["elapsed_s"] for e in exchanges],
            "wire_bytes": [e["wire_bytes"] for e in exchanges],
            "sent_bytes": [e["sent_bytes"] for e in exchanges],
            "gather_s": [e["elapsed_s"] for e in seen.get("gather_shards", [])],
            "merge_lifetimes_s": [e["elapsed_s"] for e in seen.get("merge_lifetimes", [])],
            "lifetimes": len(seen.get("pull_table", [])),
            "shard_sizes": [e["sizes"] for e in seen.get("shard_sizes", [])],
            "peak_device_bytes": ({str(d): torch.cuda.max_memory_allocated(d)
                                   for d in mesh.devices} if cuda else "not measured"),
            "rss_before_bytes": rss_before, "peak_rss_bytes": sampler.peak_rss,
            "busy_share": sampler.busy if cuda else "not measured"}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cards", default="1,2,4")
    ap.add_argument("--inputs", default="reads,genome")
    ap.add_argument("--reads-bases", type=int, default=chip_smoke.MAIN_BASES)
    ap.add_argument("--genome-bases", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default=None, help="cpu: CPU slots, a rehearsal")
    args = ap.parse_args()
    cards = [int(c) for c in args.cards.split(",")]
    cuda = args.device != "cpu"
    if cuda and not torch.cuda.is_available():
        print("sharded_local: no CUDA device (--device cpu rehearses)", file=sys.stderr)
        return 2
    os.environ["KRUST_ENGINE"] = "device"
    gpu = chip_smoke._gpu_line() if cuda else "cpu"
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)

    def emit(row):
        row["gpu"] = gpu
        print(json.dumps(row), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(row) + "\n")

    if cuda:
        from krust_tpu_torch.ops import _cuda

        torch.cuda.init()  # the allocator's per-card stats exist from here on
        _cuda.library()
        n_cards = torch.cuda.device_count()
        smi = subprocess.run(["nvidia-smi", "--query-gpu=index,name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True)
        emit({"tool": "sharded_local", "torch": torch.__version__, "cards": n_cards,
              "nvidia_smi": smi.stdout.strip().splitlines(),
              "peer_access": [[i == j or torch.cuda.can_device_access_peer(i, j)
                               for j in range(n_cards)] for i in range(n_cards)],
              "host_mem_total_bytes": chip_smoke._mem_total(),
              "kernel_build_s": _cuda.build_seconds})
    seen: dict = {}

    def collect(kind, name, fields):
        if name in ("sharded_exchange", "shard_sizes", "gather_shards", "pull_table",
                    "merge_lifetimes"):
            seen.setdefault(name, []).append(fields)

    tracing.add_collector(collect)
    rng = np.random.default_rng(args.seed)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            for name in args.inputs.split(","):
                path = os.path.join(tmp, f"{name}.fa")
                t0 = time.perf_counter()
                if name == "reads":
                    k, bases = 21, args.reads_bases
                    chip_smoke.write_reads(path, rng, bases, chip_smoke.GENOME)
                else:
                    k = 31
                    bases = args.genome_bases or max(chip_smoke.C3_MIN_BASES, min(
                        chip_smoke.C3_BASES, int(chip_smoke._mem_total()
                                                 / chip_smoke.C3_HOST_SPARE
                                                 / chip_smoke.C3_HOST_BYTES_PER_BASE)))
                    bases = sum(chip_smoke.write_genome(path, rng, bases))
                gen_s = time.perf_counter() - t0
                t0 = time.perf_counter()
                exp = chip_smoke._native_counts(path, k)
                native_s = time.perf_counter() - t0
                emit({"tool": "sharded_local", "input": name, "k": k, "bases": bases,
                      "file_bytes": os.path.getsize(path), "distinct": exp.distinct,
                      "total": exp.total, "data_gen_s": gen_s, "native_core_s": native_s})
                for n in cards:  # a line a count, so a cut run keeps the counts done
                    emit({"tool": "sharded_local", "input": name, "k": k,
                          **_count(path, k, n, cuda, exp, seen)})
                del exp
                os.unlink(path)
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            dryrun_multichip(max(cards), None if cuda else "cpu")
        emit({"tool": "sharded_local", "dryrun_multichip": out.getvalue().strip()})
    finally:
        tracing.remove_collector(collect)
    return 0


if __name__ == "__main__":
    sys.exit(main())
