"""Where the time goes on krust_tpu_torch's main path, on one CUDA device.

    python3 tools/profile_torch_main_path.py [--k 21] [--mbases 512] [--seed 0] [--dirty]
                                             [--lsm]

Writes chip_smoke.py's workload (250 bp reads at 32x over a 16 Mbase genome,
numpy from --seed) as FASTA under a temp directory, or with ``--dirty``
phase 7's FASTQ (about 5% of bases N or below Q20, counted at -Q 20: the
dense path), counts it once to warm up, then prints JSON lines:

- ``host_phases``: wall seconds of file read, parse, and the device count
  (``BatchEngine.count``: scan/pack, feed, enqueue, epoch flush, pull),
  the C++ flat scan alone or, with ``--dirty``, the dense packer
  ``pack_buffer_2bit`` alone (part of the count), and the engine's span
  totals (host time inside each span: enqueue, not device time) — one
  unprofiled run;
- ``device``: one run under ``torch.profiler`` (CPU + CUDA activities):
  device time by kernel or copy name (every name, longest first),
  device-busy time (the union of kernel and copy intervals), wall time of
  the count and the device's idle share (1 - busy / wall).

``--lsm`` counts through the LSM ``DeviceTable`` (``use_epoch_sort=False``:
compactions by ``merge_runs``) in place of the epoch-sort table.

``KRUST_EPOCH_ENTRIES`` set below the input's window count splits the
count into epochs, so the profile also shows the part merges.

Every line carries the GPU's name and power limit (nvidia-smi).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from collections import defaultdict

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import GENOME, write_reads  # noqa: E402
from krust_tpu_torch.io.format import SequenceFormat  # noqa: E402
from krust_tpu_torch.io.packer import flat_scan, pack_buffer_2bit  # noqa: E402
from krust_tpu_torch.io.reader import parse_to_streams, read_input_bytes  # noqa: E402
from krust_tpu_torch.models.engines import BatchEngine  # noqa: E402
from krust_tpu_torch.utils import tracing  # noqa: E402
from krust_tpu_torch.utils.config import EngineConfig  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--k", type=int, default=21)
    ap.add_argument("--mbases", type=int, default=512)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dirty", action="store_true",
                    help="phase 7's dirty FASTQ at -Q 20 (the dense path)")
    ap.add_argument("--lsm", action="store_true",
                    help="the LSM DeviceTable (use_epoch_sort=False)")
    args = ap.parse_args()
    q = 20 if args.dirty else None
    if not torch.cuda.is_available():
        print("profile: no CUDA device", file=sys.stderr)
        return 2
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    engine = BatchEngine(EngineConfig(device="cuda", use_epoch_sort=not args.lsm))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "reads.fq" if args.dirty else "reads.fa")
        rates = dict(fastq=True, n_rate=0.02, lowq_rate=0.03) if args.dirty else {}
        write_reads(path, np.random.default_rng(args.seed), args.mbases * 1_000_000, GENOME,
                    **rates)
        fmt = SequenceFormat.AUTO.resolve(path)
        engine.count(parse_to_streams(read_input_bytes(path), fmt), args.k, q)  # warm-up

        spans: dict[str, float] = defaultdict(float)

        def collect(kind, name, fields):
            if kind == "span":
                spans[name] += fields["elapsed_s"]

        t0 = time.perf_counter()
        data = read_input_bytes(path)
        t1 = time.perf_counter()
        streams = parse_to_streams(data, fmt)
        t2 = time.perf_counter()
        tracing.add_collector(collect)
        try:
            engine.count(streams, args.k, q)
        finally:
            tracing.remove_collector(collect)
        t3 = time.perf_counter()
        if args.dirty:
            sum(1 for _ in pack_buffer_2bit(streams.codes, streams.qual, args.k, q + 33))
            pack = "pack_buffer_2bit_s (inside count_s)"
        else:
            flat_scan(streams.codes, None, None, streams.codes.shape[0] // 32)
            pack = "flat_scan_s (inside count_s)"
        t4 = time.perf_counter()
        print(json.dumps({
            "host_phases": {"read_s": t1 - t0, "parse_s": t2 - t1, "count_s": t3 - t2,
                            pack: t4 - t3},
            "spans_s": dict(spans), "k": args.k, "mbases": args.mbases,
            "dirty": args.dirty, "lsm": args.lsm, "gpu": gpu,
        }), flush=True)

        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            engine.count(streams, args.k, q)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        # device activity: kernels and copies (not the profiler's user-
        # annotation ranges), busy time as the union of their intervals
        by_name: dict[str, list] = defaultdict(lambda: [0.0, 0])
        intervals = []
        for ev in prof.events():
            if ev.device_type != torch.autograd.DeviceType.CUDA or getattr(
                ev, "is_user_annotation", False
            ):
                continue
            start, end = ev.time_range.start, ev.time_range.end
            intervals.append((start, end))
            by_name[ev.name][0] += end - start
            by_name[ev.name][1] += 1
        busy_us, last = 0.0, float("-inf")
        for start, end in sorted(intervals):
            if end > last:
                busy_us += end - max(start, last)
                last = end
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])
        print(json.dumps({
            "device": [{"name": n[:90], "ms": v[0] / 1e3, "calls": v[1]} for n, v in top],
            "device_busy_s": busy_us / 1e6, "wall_s": wall,
            "idle_share": 1 - busy_us / 1e6 / wall,
            "k": args.k, "mbases": args.mbases, "dirty": args.dirty, "lsm": args.lsm,
            "gpu": gpu,
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
