"""Smoke test of krust_tpu_torch on one NVIDIA GPU: kernels, then the counting paths.

    python3 chip_smoke.py [--seed N] [--phases 1,2,3,4,5,6,7,8,9,10,11]

Needs a CUDA device and ``nvcc`` (the kernels build from
``krust_tpu_torch/csrc`` at first use, one nvcc per source, in parallel).
Phases, printing JSON lines:

1. environment: GPU name and power limit, torch / CUDA / nvcc versions,
   kernel build time, the host's MemTotal and the card's total memory, and
   each kernel's registers, shared memory and spills as ptxas reported
   them;
2. each CUDA kernel against its plain PyTorch version on the card, at the
   main path's shapes, exactly equal (integer work: tolerance 0), with
   kernel and plain times, the least time the card could take for the same
   work (``bound_ms``) and, where one PyTorch call computes the same
   function, that call's time (``library_ms``; never called by the port).
   K1 also runs with no invalid position, K2 on one run over every
   tile, and K4 at narrower rows (256 and 8 windows, equality only).
   K4's code form (every window's code, bad bases as 0 on both strands,
   and poison words) against its plain version at the narrower rows too.
   ``ops.codec.encode_blocks`` (krust_tpu's public codec: rows packed on
   the card, K4's code form, the codes split into hi, lo and valid) runs
   at K4's main shape with quality at k = 16, 21 and 32, each call first
   as a path of its own (counts zeroed, read after: K4 once), then against
   its plain version on every window (tolerance 0, invalid windows
   included), with its time and K4's own in both forms. The
   LSM table's ``merge_runs`` (``torch.sort`` plus K2 weighted) runs at a
   compaction's size, 8 x 33.5M raw keys plus a 2^26-entry table, against
   its CPU result. K3 runs on two random parts of 2^24 entries and on two parts
   shaped like phase 4's merge (2^26 entries each, about 46M distinct keys
   that both parts share, sentinel tails), in both key widths; the kernel
   line takes the int64 shared row. K5 lies on no counting path: its
   launches in the kernel line are those of its timing here. K6 (the
   count-of-counts at the table pull) runs on the assembly cell's 112.9M
   counts, with torch.bincount over the counts capped at its bins as
   ``library_ms``. K2 and K3
   also run on 2^31 - 2^20 + 7 int64 entries (a table lifetime's last
   merge), checked against their closed form. Then the table's memory:
   peak device bytes of an epoch flush (2^26, 2^28, 2^30 raw keys, int64
   and int32), a part merge (2 x 2^24, 2^26, 2^28 entries) and
   ``merge_runs`` (2, 8 and 24 batches), each fit to fixed + per entry x
   n; the entry limits derived from the fits beside ``ops/table.py``'s
   constants, whose worst cases must fit the budget;
3. bench.py's workload: 512 Mbases of 250 bp reads at 32x over a 16 Mbase
   genome (made with numpy from --seed), written as FASTA and counted at
   k = 21 through ``api.count_with_input`` with KRUST_ENGINE=device, once,
   timed; the full table must equal the native C++ core's. It fits one
   epoch of the default size, so it launches no merge;
4. the clean main path at the default, memory-scaled epoch size: 1.25
   epochs of reads at 32x (about 1.57 Gbases on an 80 GB card), k = 21, so
   the table sorts two epochs and merges their parts. The launch counters
   are set to 0 just before this count and read just after it; K1-K3 must
   have launched. Peak device memory is recorded and must stay within the
   table's budget. Equal to the native core;
5. multi-epoch: 64 Mbases with KRUST_EPOCH_ENTRIES = 2^22 at k = 16 and 31
   (both key widths of the merge kernel), equal to the native core;
6. edge k and masks on the flat path: FASTQ with Ns, soft-masking and
   -Q 20 at k in {1, 5, 17, 24, 32}, ~8 Mbases each, equal to the native
   core; plus one CLI run (``python -m krust_tpu_torch``) against it;
7. the dense path at full size: 512 Mbases of 250 bp FASTQ reads at 32x
   over a 16 Mbase genome with about 5% of bases N or below Q20 (above the
   1/32 line), counted at -Q 20, k = 21, once, timed, with the counters
   set to 0 just before the count (K4 and K2 must launch, K1 must not),
   equal to the native core; the host time of ``pack_buffer_2bit``'s own
   whole-stream pack (``dense_pack_s``: the native pack on the host's
   cores, numpy without the library) and of the route scan without its
   1/32 limit (``route_scan_unlimited_s``: the count, then the flat pack
   with the positions); the same parsed stream timed on both device routes
   (dense, and flat with the 1/32 limit lifted); a dirty ~8 Mbase
   FASTQ at k in {1, 5, 16, 17, 24, 32} and one block_windows = 8 count;
8. the LSM table path (``EngineConfig(use_epoch_sort=False)``: the
   ``DeviceTable``, compactions by ``merge_runs``) on phase 3's workload,
   counters set to 0 just before (K1 and K2 must launch, ``merge_sorted``
   must not), timed, with peak device memory; then 64 Mbases at k = 16
   (int32 keys) and a dirty 8 Mbase FASTQ at -Q 20 (K4 into the
   ``DeviceTable``). Every table equal to the native core's;
9. the sharded path (``api.count_kmers_sharded_result``) on phase 3's file
   at k = 21: once with no process group, whose mesh is every card (one
   card: no exchange), timed, with peak device memory, after a plain
   count of the same file (``api.count_with_input``), then once inside a
   one-rank NCCL group (``file://`` init in the temporary directory,
   destroyed after), where the owner order, the split sizes and both
   ``all_to_all_single`` payloads run on the card; its ``wire_bytes`` and
   ``shard_sizes`` are printed. Counters set to 0 just before each count:
   K1 and K2 must launch, K4 must not. Then a dirty 8 Mbase FASTQ at -Q 20
   in both settings (K4 must launch, K1 must not). Inside the NCCL group,
   a mesh of 4 slots of cuda:0 counts phase 3's file at k = 21 and the
   dirty FASTQ at -Q 20, counters at 0 just before each (K1 or K4, K2 and
   K3 must launch; 4 shard sizes an exchange, nothing sent between
   processes). Then two ranks of a gloo group in two children on the one
   card, 2 slots of it each, rank 0 on phase 3's file and rank 1 on the
   dirty FASTQ: their union equal to the native tables summed, each rank's
   keys its own slots'; where gloo refuses CUDA tensors in
   ``all_to_all_single``, the line says so. Then one process over a
   mesh of 4 slots on the one card (and over every card when there are
   two or more): phase 4's file at k = 21 with the table lifetime cut to
   2^30 windows (two exchanges), the dirty FASTQ at -Q 20 and phase 3's
   file at k = 15, each with the counters at 0 just before (K1 or K4, K2
   and K3 must launch), its seconds, per-card peak, exchanges,
   ``wire_bytes`` and the slots' shard sizes, the shards disjoint; then
   ``krust_tpu_torch.entry.dryrun_multichip`` over every card. Then
   phase 3's file over 3 slots of the one card at k = 21 and over 8 at
   k = 15, counters at 0 just before each: each slot's shard equal to the
   native core's table cut by a numpy copy of the owner formula
   (``krust_tpu``'s hash of the code's halves, mod the slots). Every
   table equal to the native core's;
10. BASELINE.md's five configurations and the streaming path, through the
   entry points users call. Every CLI run is the port's CLI entry point
   (``krust_tpu_torch.cli:main``, the ``kmix-torch`` script) in a child
   process with KRUST_ENGINE=device, held byte for byte against the same
   CLI with KRUST_ENGINE=native (the native C++ core); each child reports
   its runs' kernel launches (counters at 0 before each run) and device
   peak, the parent its peak RSS (``os.wait4``). C1: the six
   ``tests/fixtures`` files x k in {1, 5, 21, 32} x the four formats at
   ``--min-count 2`` (-Q 20 for FASTQ), 96 runs a child. C2: 64 Mbases of
   phase 7's dirty FASTQ recipe at 32x, k = 21, ``-Q 20 -f tsv`` (K4 must
   launch). C3: a genome-shaped FASTA of C3_BASES, GRCh38's 3.1 Gbases
   (24 chromosomes in its proportions, half soft-masked, 1% N runs), cut
   to what the host's MemTotal holds but never below 2.3 Gbases, at k = 31
   through stdin (the chunked path, 256 MiB chunks), ``-f histogram``: at
   least two table lifetimes (2^31 windows each), a part merge (K3) in
   each full one, the device peak within the table's budget. C4: phase
   3's file, ``--save`` a ``.kmix`` (equal to the bytes of the index of the
   native core's table), 10 ``query`` runs and 100k ``load_index(...).get``.
   C5: phase 3's recipe as a 128 Mbase gzip FASTQ through
   ``api.count_kmers_streaming_packed``, then ``count_kmers_sharded_result``
   in a one-rank NCCL group, in this process. S: phase 4's 1.25-epoch file
   (kept from phase 4, else made anew) through
   ``api.count_kmers_streaming_packed`` in a child: 256 MiB chunks that
   cross an epoch flush, so K1, K2 and K3 must launch.
11. krust_tpu's own behaviour suites against the port
   (``tests/torch_reference_suite.py``: the ``tests/test_torch_ref_*.py``
   loaders but the CLI's, ``PHASE11_LEFT_OUT``) in a child process, with
   ``--noconftest`` (conftest.py imports JAX), ``-m 'not slow'`` and
   KRUST_PLATFORM and KRUST_ENGINE unset, so that auto-dispatch takes the
   batch engine on the card and the forms layer
   (``tests/torch_reference_forms.py``) sends krust_tpu's kernel, count
   and table call forms to the kernels (the kernel, codec, flat-path and
   table suites, ``PHASE11_FORMED``). Any failure, error or xpass fails
   the phase, and so does a run in which K1, K2, K3 or K5 never launched;
   the line gives the outcomes, the seconds, each kernel's launches (K4's
   among them) and each formed file's passes, xfails and seconds.

The second-to-last line is the kernel table (launches from each kernel's
phase plus those of phase 2's ``encode_blocks`` path, from phase 9's mesh
count of phase 4's file, from its 4-slot counts in the NCCL group and
from phase 11's suites, times from phase 2), the last line the result.
Any failed check raises: the script exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

READ_LEN = 250
GENOME = 16_000_000
MAIN_BASES = 512_000_000
ALL_PHASES = {1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11}
#: phase 10's inputs: C2's dirty FASTQ, C3's genome-shaped FASTA (GRCh38's
#: 3.1 Gbases), C5's gzip FASTQ
C2_BASES = 64_000_000
C3_BASES = 3_100_000_000
C5_BASES = 128_000_000
#: C3 is cut to the largest genome whose CLI children (the port's and the
#: native core's, one at a time) the host's MemTotal holds with 20% to
#: spare, at C3_HOST_BYTES_PER_BASE host bytes a base: the native core's
#: CLI child, the larger of the two, peaked at 37.6 GB on a 1 Gbase genome
#: (the H100 host). It is never cut below C3_MIN_BASES, which still crosses
#: a table lifetime (EPOCH_WINDOW_LIMIT = 2^31 windows)
C3_MIN_BASES = 2_300_000_000
C3_HOST_BYTES_PER_BASE = 37.6
C3_HOST_SPARE = 1.2

#: phase 9's table lifetime for the mesh's count of phase 4's file (1.57G
#: windows on an 80 GB card): half the default, so that the slots exchange
#: twice
MESH_WINDOW_LIMIT = 1 << 30

#: loaders phase 11 leaves out: the CLI's tests start a CLI process each
#: with the native engine (about 8 s a test on the H100's host), and phase
#: 10 runs the CLI on the card; the meta-test holds the loaders themselves
PHASE11_LEFT_OUT = ("tests/test_torch_ref_cli.py", "tests/test_torch_ref_meta.py")

#: the reference files phase 11 runs through krust_tpu's (hi, lo) call
#: forms (tests/torch_reference_suite.py FORMED), reported one by one
PHASE11_FORMED = ("test_codec", "test_epoch_table", "test_flat", "test_pallas",
                  "test_pallas_fused", "test_pallas_merge", "test_pallas_rle", "test_table")

#: the card's peaks the bound is taken against (NVIDIA H100 SXM data sheet):
#: HBM bytes/s, and the float32 rate outside the tensor cores as the rate
#: of the kernels' integer ALU work
HBM_BYTES_PER_S = 3.35e12
ALU_OPS_PER_S = 67e12


def _gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def _emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def _time_ms(fn, reps: int = 5) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _bound(n_bytes: float, n_ops: float) -> dict:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over the ALU rate."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ALU_OPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops
            else "operations", "bound_bytes": n_bytes, "bound_ops": n_ops}


def _codec_ops(n_windows: int, k: int) -> float:
    """Integer operations of a codec, whatever implements it: per window one
    forward code (a shift and a mask of the 2k window bits), one reverse
    complement (a complement and a reversal of the k base pairs, one
    operation a base), one minimum and one validity test over the window's
    k flags (one operation a base). No fewer than the kernels spend."""
    return n_windows * (2 * k + 10)


def _merge_ops(n_out: int) -> float:
    """Integer operations of a merge, whatever implements it: one compare
    and one select per output entry."""
    return 2 * n_out


def _max_abs_err(pairs) -> int:
    err = 0
    for got, exp in pairs:
        if got.shape != exp.shape:
            raise AssertionError(f"shape {tuple(got.shape)} != {tuple(exp.shape)}")
        d = (got.to(exp.dtype) - exp).abs().max().item() if got.numel() else 0
        err = max(err, int(d))
    return err


def _mem_total() -> int:
    """The host's MemTotal (``/proc/meminfo``), in bytes."""
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemTotal:"):
                return int(line.split()[1]) * 1024
    raise AssertionError("no MemTotal in /proc/meminfo")


def _fit(points) -> tuple[float, float]:
    """Least-squares (fixed, per_entry) of bytes = fixed + per_entry * n
    over (n, bytes) points."""
    per_entry, fixed = np.polyfit([float(n) for n, _ in points],
                                  [float(b) for _, b in points], 1)
    return float(fixed), float(per_entry)


# --- phase 2: kernels against their plain versions ------------------------------


def _check_codec(rng, gpu, dev, results):
    import torch

    from krust_tpu_torch.io.packer import pack2_full
    from krust_tpu_torch.kmer import INVALID_CODE
    from krust_tpu_torch.ops.fused_codec import (
        TAIL_BYTES, encode_windows, encode_windows_plain,
    )

    rows, w = 8192, 4096
    n_windows = rows * w
    times = {}
    # 1% invalid at each key width, and none at the main path's k (the gap
    # between the two k = 21 rows is what validity costs)
    for k, rate in ((16, 0.01), (21, 0.01), (31, 0.01), (32, 0.01), (21, 0.0)):
        n_bases = n_windows + k - 1
        codes = rng.integers(0, 4, size=n_bases, dtype=np.uint8)
        codes[rng.random(n_bases) < rate] = INVALID_CODE
        inv = np.flatnonzero(codes >= INVALID_CODE).astype(np.int32)
        packed = np.zeros(n_windows // 4 + TAIL_BYTES, np.uint8)
        p = pack2_full(codes)
        packed[: p.shape[0]] = p
        covered = n_windows - 1000  # a ragged tail of padding windows
        pk = torch.from_numpy(packed).to(dev)
        iv = torch.from_numpy(inv).to(dev)
        got = encode_windows(pk, iv, covered, k, n_windows)
        torch.cuda.synchronize()
        if not np.array_equal(iv.cpu().numpy(), inv):  # read back after the kernel
            raise AssertionError(f"K1 k={k}: invalid positions changed on the card")
        exp = encode_windows_plain(pk, iv, covered, k, n_windows)
        torch.cuda.synchronize()
        err = _max_abs_err([(got, exp)])
        if not torch.equal(got, exp):
            raise AssertionError(f"K1 k={k} invalid={rate}: kernel != plain")
        ms = _time_ms(lambda: encode_windows(pk, iv, covered, k, n_windows))
        plain_ms = _time_ms(lambda: encode_windows_plain(pk, iv, covered, k, n_windows), 2)
        bound = _bound(pk.numel() + 4 * iv.numel() + got.numel() * got.element_size(),
                       _codec_ops(n_windows, k))
        times[k, rate] = {"ms": ms, "plain_ms": plain_ms, "max_abs_err": err,
                          "library_ms": None, **bound}
        _emit({"phase": 2, "kernel": "encode_windows", "k": k, "windows": n_windows,
               "invalid_share": rate, "invalid_positions": int(inv.shape[0]),
               "equal": True, **times[k, rate], "gpu": gpu})
    # the main path's k; no single PyTorch call computes the poisoned keys
    results["encode_windows"] = dict(
        times[21, 0.01], max_abs_err=max(t["max_abs_err"] for t in times.values())
    )


def _sorted_keys(g, n, n_distinct, dtype, dev):
    import torch

    # biased keys of real codes: k = 16 codes span all 32 bits; k = 21 codes
    # span 42 bits, i.e. [INT64_MIN, INT64_MIN + 2^42) biased
    lo = torch.iinfo(dtype).min
    span = 2**32 - 1 if dtype == torch.int32 else 2**42
    pool = torch.randint(lo, lo + span, (n_distinct,), generator=g, device=dev,
                         dtype=dtype)
    idx = torch.randint(0, n_distinct, (n,), generator=g, device=dev)
    keys = torch.sort(pool[idx]).values
    keys[n - n // 64 :] = torch.iinfo(dtype).max  # sentinel tail
    return keys


def _check_rle(g, gpu, dev, results):
    import torch

    from krust_tpu_torch.ops.rle import rle_compact, rle_compact_plain

    n = 134_217_728
    timed = None
    # random runs (n / 16 distinct) in both key widths, weighted and not; then
    # one run over every tile, which carries the look-back through them all
    rows = [(torch.int64, False, "random"), (torch.int64, True, "random"),
            (torch.int32, False, "random"), (torch.int64, False, "one_run")]
    for dtype, weighted, stream in rows:
        keys = _sorted_keys(g, n, n // 16, dtype, dev)
        if stream == "one_run":
            keys[: n - n // 64] = keys[0].item()
        cnt = (
            torch.randint(1, 100, (n,), generator=g, device=dev, dtype=torch.int32)
            if weighted else None
        )
        got = rle_compact(keys, cnt)
        exp = rle_compact_plain(keys, cnt)
        torch.cuda.synchronize()
        err = _max_abs_err(zip(got, exp))
        if err or not all(torch.equal(a, b) for a, b in zip(got, exp)):
            raise AssertionError(f"K2 {dtype} weighted={weighted} {stream}: kernel != plain")
        ms = _time_ms(lambda: rle_compact(keys, cnt))
        plain_ms = _time_ms(lambda: rle_compact_plain(keys, cnt), 2)
        # unit weights: one PyTorch call computes the same runs and counts
        library_ms = None if weighted else _time_ms(
            lambda: torch.unique_consecutive(keys, return_counts=True)
        )
        ks = keys.element_size()
        n_bytes = n * ks + (4 * n if weighted else 0) + n * (ks + 4) + 8
        row = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
               "max_abs_err": err, **_bound(n_bytes, 12 * n)}
        _emit({"phase": 2, "kernel": "rle_compact", "keys": str(dtype), "n": n,
               "weighted": weighted, "stream": stream, "n_unique": int(got[2].item()),
               "equal": True, **row, "gpu": gpu})
        if timed is None:
            timed = row
        del keys, cnt, got, exp
    results["rle_compact"] = timed


def _check_histogram(g, gpu, dev, results):
    """K6 at the assembly cell's table: 112.9M skewed int32 counts, most 1,
    a pareto tail past the bins (so the overflow launch runs)."""
    import torch

    from krust_tpu_torch.ops import _cuda
    from krust_tpu_torch.ops.histogram import BINS, count_histogram, count_histogram_plain

    n = 112_900_000
    u = torch.rand(n, generator=g, device=dev, dtype=torch.float64)
    counts = torch.clamp(torch.floor(u.pow(-1 / 1.5)), max=2**31 - 1).to(torch.int32)
    del u
    got = count_histogram(counts)
    exp = count_histogram_plain(counts)
    if not (np.array_equal(got.values, exp.values) and np.array_equal(got.freqs, exp.freqs)):
        raise AssertionError("K6: kernel != plain")
    lib, acc = _cuda.library(), torch.empty(BINS + 1, dtype=torch.int64, device=dev)
    stream = _cuda.stream_of(counts)

    def kernel():  # the bins' launch alone, as the pull's device time has it
        _cuda.check("count_histogram", lib.krust_count_histogram(
            dev.index, counts.data_ptr(), n, BINS, acc.data_ptr(), stream))

    ms = _time_ms(kernel, 20)
    start = time.perf_counter()
    for _ in range(5):
        count_histogram(counts)
    call_ms = (time.perf_counter() - start) / 5 * 1e3
    capped = counts.clamp(max=BINS)
    row = {"ms": ms, "call_ms": call_ms, "plain_ms": _time_ms(
        lambda: count_histogram_plain(counts), 2),
        "library_ms": _time_ms(lambda: torch.bincount(capped, minlength=BINS + 1)),
        "library": "torch.bincount over the counts capped at BINS", "max_abs_err": 0,
        **_bound(4 * n + 8 * (BINS + 1), 2 * n)}
    _emit({"phase": 2, "kernel": "count_histogram", "n": n, "bins": BINS,
           "n_over": int(exp.freqs[exp.values >= BINS].sum()),
           "distinct_counts": int(exp.values.size), "equal": True, **row, "gpu": gpu})
    results["count_histogram"] = row
    del counts, capped


def _shared_parts(g, dtype, dev, m=1 << 26):
    """Two compacted parts shaped like phase 4's merge: m = 2^26 entries
    each (round_pow2 of about 46M distinct keys; other m keep the share),
    part a the whole sorted pool, part b about 99.7% of it (two epochs over
    one genome), counts 1-500, sentinel tails with count 0."""
    import torch

    lo = torch.iinfo(dtype).min
    span = 2**32 - 1 if dtype == torch.int32 else 2**42
    pool = torch.unique(torch.randint(lo, lo + span, (46_000_000 * m >> 26,), generator=g,
                                      device=dev, dtype=dtype))
    keep = torch.rand(pool.numel(), generator=g, device=dev) < 0.997
    parts = []
    for keys in (pool, pool[keep]):
        n = keys.numel()
        pk = torch.full((m,), torch.iinfo(dtype).max, dtype=dtype, device=dev)
        pk[:n] = keys
        pc = torch.zeros(m, dtype=torch.int32, device=dev)
        pc[:n] = torch.randint(1, 501, (n,), generator=g, device=dev, dtype=torch.int32)
        parts += [pk, pc]
    return parts


def _check_merge(g, gpu, dev, results):
    import torch

    from krust_tpu_torch.ops.merge import merge_sorted, merge_sorted_plain
    from krust_tpu_torch.ops.rle import rle_compact_plain

    m = 1 << 24
    for shape in ("random", "shared"):
        for dtype in (torch.int64, torch.int32):
            if shape == "random":
                parts = []
                for _ in range(2):
                    keys = _sorted_keys(g, m, m // 2, dtype, dev)
                    ck, cc, _ = rle_compact_plain(keys)  # a compacted part: unique + tail
                    parts += [ck, cc]
            else:
                parts = _shared_parts(g, dtype, dev)
            got = merge_sorted(*parts)
            exp = merge_sorted_plain(*parts)
            torch.cuda.synchronize()
            err = _max_abs_err(zip(got, exp))
            if err or not all(torch.equal(a, b) for a, b in zip(got, exp)):
                raise AssertionError(f"K3 {dtype} {shape}: kernel != plain")
            del got, exp
            ms = _time_ms(lambda: merge_sorted(*parts))
            plain_ms = _time_ms(lambda: merge_sorted_plain(*parts), 2)
            ma, mb = parts[0].numel(), parts[2].numel()
            n_bytes = 2 * (ma + mb) * (parts[0].element_size() + 4)
            # no single PyTorch call merges a payload along with the keys
            row = {"ms": ms, "plain_ms": plain_ms, "library_ms": None, "max_abs_err": err,
                   **_bound(n_bytes, _merge_ops(ma + mb))}
            _emit({"phase": 2, "kernel": "merge_sorted", "keys": str(dtype), "parts": shape,
                   "entries": [ma, mb], "equal": True, **row, "gpu": gpu})
            if shape == "shared" and dtype == torch.int64:
                results["merge_sorted"] = row  # the main path's merge at k = 21
            del parts


def _check_dense(rng, gpu, dev, results):
    """K4 at the dense path's batch shape: 8192 rows x 4096 windows, about
    7% bad bits, the last 100 rows all-bad padding."""
    import torch

    from krust_tpu_torch.ops.codec import encode_dense, encode_dense_plain

    rows, w = 8192, 4096
    times = {}
    for k in (16, 21, 31, 32):
        width = w + k - 1
        p4, p8 = -(-width // 4), -(-width // 8)
        packed2 = rng.integers(0, 256, size=(rows, p4), dtype=np.uint8)
        badbits = np.packbits(rng.random((rows, 8 * p8)) < 0.07, axis=1)
        packed2[-100:] = 0
        badbits[-100:] = 0xFF
        p2 = torch.from_numpy(packed2).to(dev)
        bb = torch.from_numpy(badbits).to(dev)
        got = encode_dense(p2, bb, k, w)
        exp = encode_dense_plain(p2, bb, k, w)
        torch.cuda.synchronize()
        err = _max_abs_err([(got, exp)])
        if not torch.equal(got, exp):
            raise AssertionError(f"K4 k={k}: kernel != plain")
        ms = _time_ms(lambda: encode_dense(p2, bb, k, w))
        plain_ms = _time_ms(lambda: encode_dense_plain(p2, bb, k, w), 2)
        bound = _bound(p2.numel() + bb.numel() + got.numel() * got.element_size(),
                       _codec_ops(rows * w, k))
        # no single PyTorch call computes the poisoned keys
        times[k] = {"ms": ms, "plain_ms": plain_ms, "max_abs_err": err,
                    "library_ms": None, **bound}
        _emit({"phase": 2, "kernel": "encode_dense", "k": k, "rows": rows,
               "block_windows": w, "equal": True, **times[k], "gpu": gpu})
        del p2, bb, got, exp
    # narrower rows at the same volume, equality only: 16 rows a block at 256
    # windows, and 8 (phase 7's block_windows = 8 count), whose runs of 32
    # windows hold 8 and are stored by their threads
    for w, k in ((256, 21), (256, 16), (8, 21), (8, 16)):
        n_rows = rows * 4096 // w
        width = w + k - 1
        p4, p8 = -(-width // 4), -(-width // 8)
        p2 = torch.from_numpy(rng.integers(0, 256, size=(n_rows, p4), dtype=np.uint8)).to(dev)
        bb = torch.from_numpy(
            np.packbits(rng.random((n_rows, 8 * p8)) < 0.07, axis=1)).to(dev)
        if not torch.equal(encode_dense(p2, bb, k, w), encode_dense_plain(p2, bb, k, w)):
            raise AssertionError(f"K4 k={k} block_windows={w}: kernel != plain")
        got = encode_dense(p2, bb, k, w, codes=True)
        exp = encode_dense_plain(p2, bb, k, w, codes=True)
        if not all(torch.equal(a, b) for a, b in zip(got, exp)):
            raise AssertionError(f"K4 code form k={k} block_windows={w}: kernel != plain")
        del got, exp
        _emit({"phase": 2, "kernel": "encode_dense", "k": k, "rows": n_rows,
               "block_windows": w, "equal": True, "code_form_equal": True})
        del p2, bb
    results["encode_dense"] = dict(
        times[21], max_abs_err=max(t["max_abs_err"] for t in times.values())
    )


def _check_encode_blocks(rng, gpu, dev, results):
    """``ops.codec.encode_blocks``, krust_tpu's public codec, on the card at
    K4's main shape: 8192 rows x 4096 windows, 7% bad bases, quality bytes
    5% below the threshold 53 (Q20). For each k in 16, 21, 32 the path
    runs first: the counts zeroed, one ``encode_blocks`` call, the counts
    read (K4 once, no other kernel). Then its output against its plain
    version on the same rows, ``hi``, ``lo`` and ``valid`` on every window
    (tolerance 0; where a window is not valid, the code of krust_tpu's
    substitution), its time (pack, K4's code form and split) and K4's own
    on the packed rows in both forms, each beside its bound."""
    import torch

    from krust_tpu_torch.kmer import INVALID_CODE
    from krust_tpu_torch.ops import codec

    rows, w, thr = 8192, 4096, ord("5")
    launches = {}
    for k in (16, 21, 32):
        shape = (rows, w + k - 1)
        codes = rng.integers(0, 4, size=shape, dtype=np.uint8)
        codes[rng.random(shape) < 0.07] = INVALID_CODE
        qual = np.where(rng.random(shape) < 0.05, ord("#"), ord("I")).astype(np.uint8)
        c, q = torch.from_numpy(codes).to(dev), torch.from_numpy(qual).to(dev)
        del codes, qual
        _zero_launches()
        got = codec.encode_blocks(c, k, q, thr)
        torch.cuda.synchronize()
        path = _launches()
        if path["encode_dense"] != 1 or sum(path.values()) != 1:
            raise AssertionError(f"encode_blocks k={k}: launches {path}")
        for name, n in path.items():
            launches[name] = launches.get(name, 0) + n
        exp = codec.encode_blocks_plain(c, k, q, thr)
        wide = [(a.to(torch.int64), b.to(torch.int64)) for a, b in zip(got, exp)]
        err = _max_abs_err(wide)  # int64 views: CUDA torch has no uint32 arithmetic
        if err or not all(torch.equal(a, b) for a, b in wide):
            raise AssertionError(f"encode_blocks k={k}: K4 route != plain")
        valid_share = got[2].float().mean().item()
        # invalid windows whose lo is not 0: krust_tpu's substituted codes are there
        invalid_nonzero = int(((wide[1][0] != 0) & ~got[2]).sum().item())
        del got, exp, wide
        ms = _time_ms(lambda: codec.encode_blocks(c, k, q, thr))
        plain_ms = _time_ms(lambda: codec.encode_blocks_plain(c, k, q, thr), 2)
        packed2, badbits, w4 = codec.pack_rows(c, k, q, thr)
        k4_ms = _time_ms(lambda: codec.encode_dense(packed2, badbits, k, w4, codes=True))
        k4_count_ms = _time_ms(lambda: codec.encode_dense(packed2, badbits, k, w4))
        key_bytes = 4 if k <= 16 else 8
        # codes and quality read once; hi, lo (uint32) and valid (bool) written once
        bound = _bound(2 * c.numel() + 9 * rows * w, _codec_ops(rows * w, k))
        # the code form: the counting form's bytes and a uint32 of poison a run
        k4_bytes = packed2.numel() + badbits.numel() + key_bytes * rows * w4
        k4_bound = _bound(k4_bytes + 4 * rows * -(-w4 // 32), _codec_ops(rows * w4, k))
        k4_count_bound = _bound(k4_bytes, _codec_ops(rows * w4, k))
        _emit({"phase": 2, "kernel": "encode_blocks", "k": k, "rows": rows, "windows": w,
               "bad_share": 0.07, "quality_threshold": thr, "low_quality_share": 0.05,
               "valid_share": valid_share, "invalid_windows_lo_nonzero": invalid_nonzero,
               "launches": path, "equal": True, "ms": ms,
               "plain_ms": plain_ms, "max_abs_err": err, "library_ms": None, **bound,
               "k4_ms": k4_ms, "k4_bound_ms": k4_bound["bound_ms"],
               "k4_count_form_ms": k4_count_ms,
               "k4_count_form_bound_ms": k4_count_bound["bound_ms"], "gpu": gpu})
        del c, q, packed2, badbits
    results["encode_blocks_launches"] = launches


def _check_merge_keys(rng, gpu, dev, results):
    """K5 at 2 x 16.8M uint32 keys: half at or above 2^31, ties, sentinel
    tails. Its timing launches are its launches in the kernel line: no
    counting path calls it."""
    import torch

    from krust_tpu_torch.ops.merge import (
        widen_u32, merge_sorted_keys, merge_sorted_keys_plain,
    )

    m = 1 << 24
    arrays = []
    for tail in (m // 64, m // 16):
        a = np.sort(rng.integers(0, 1 << 32, m, dtype=np.uint64)[: m - tail]).astype(np.uint32)
        arrays.append(np.concatenate([a, np.full(tail, 0xFFFFFFFF, np.uint32)]))
    a, b = (torch.from_numpy(x).to(dev) for x in arrays)
    cat = torch.from_numpy(np.concatenate(arrays)).to(dev)
    got = merge_sorted_keys(a, b)
    exp = merge_sorted_keys_plain(a, b)
    torch.cuda.synchronize()
    got64, exp64 = widen_u32(got), widen_u32(exp)
    if not torch.equal(got64, exp64):
        raise AssertionError("K5: kernel != plain")
    err = _max_abs_err([(got64, exp64)])
    merge_sorted_keys.launches = 0
    ms = _time_ms(lambda: merge_sorted_keys(a, b))
    launches = merge_sorted_keys.launches
    plain_ms = _time_ms(lambda: merge_sorted_keys_plain(a, b), 2)
    # one PyTorch call computes the same function: a sort of the
    # concatenated keys (of their int64 widening where CUDA sorts no uint32)
    try:
        torch.sort(cat)
        library_call = "torch.sort(uint32)"
    except (RuntimeError, NotImplementedError):
        cat = widen_u32(cat)
        library_call = "torch.sort(int64 widening)"
    library_ms = _time_ms(lambda: torch.sort(cat))
    row = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
           "library_call": library_call, "max_abs_err": err, "launches": launches,
           **_bound(4 * 4 * m, _merge_ops(2 * m))}
    _emit({"phase": 2, "kernel": "merge_sorted_keys", "entries": [m, m], "equal": True,
           **row, "gpu": gpu})
    results["merge_sorted_keys"] = row


def _check_merge_runs(g, gpu, dev) -> list:
    """The LSM table's compaction: ``batches`` batches of 33.5M raw int64
    window keys (unit weights, 1% sentinels that weigh 0 as the table
    weighs its invalid windows, drawn from 46M distinct keys)
    plus a compacted 2^26-entry table (46M keys with counts, sentinel
    tail), through ``merge_runs``. At its full size (8 batches) also on the
    CPU (K2's plain version underneath), equal; at 2 and 24 batches for
    the memory fit only. No kernel of its own: ``torch.sort`` with the
    weights gathered after, then K2 in weighted mode. Returns the (entries,
    peak bytes with the inputs) points."""
    import torch

    from krust_tpu_torch.ops.count import merge_runs
    from krust_tpu_torch.ops.rle import rle_compact

    points = []
    for batches in (2, 8, 24):
        n_raw, m = batches * 8192 * 4096, 1 << 26
        t_keys, t_cnt = _shared_parts(g, torch.int64, dev)[:2]
        n_pool = int((t_cnt > 0).sum().item())
        raw = t_keys[torch.randint(0, n_pool, (n_raw,), generator=g, device=dev)]
        raw[torch.rand(n_raw, generator=g, device=dev) < 0.01] = torch.iinfo(torch.int64).max
        keys = torch.cat([raw, t_keys])
        cnt = torch.cat([(raw != torch.iinfo(torch.int64).max).to(torch.int32), t_cnt])
        del raw, t_keys, t_cnt
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        input_bytes = keys.numel() * 12
        before = rle_compact.launches
        got = merge_runs(keys, cnt)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        points.append((n_raw + m, peak + input_bytes))
        if rle_compact.launches != before + 1:
            raise AssertionError("merge_runs on the card did not launch K2")
        row = {"phase": 2, "function": "merge_runs", "keys": "torch.int64",
               "entries": n_raw + m, "raw": n_raw, "table": m, "n_unique": int(got[2].item()),
               "peak_bytes_above_inputs": peak, "input_bytes": input_bytes}
        if batches == 8:
            exp = merge_runs(keys.cpu(), cnt.cpu())
            for a, b in zip(got, exp):
                if not torch.equal(a.cpu(), b):
                    raise AssertionError("merge_runs: card != CPU")
            del exp
            row["equal_to_cpu"] = True
        del got
        row["merge_runs_ms"] = _time_ms(lambda: merge_runs(keys, cnt), 3)
        row["torch_sort_ms"] = _time_ms(lambda: torch.sort(keys), 3)
        _emit({**row, "gpu": gpu})
        del keys, cnt
    return points


def _memory_fits(g, gpu, dev, merge_runs_points) -> dict:
    """Peak device bytes of the table's steps, each with its inputs: an
    epoch flush (``_epoch_concat_sort_rle``) of 2^26, 2^28 and 2^30 raw
    keys in parts of one default batch (2^25 keys) as the main path
    appends them, int64 (k = 21) and int32 (k = 15); a part merge
    (``_merge_compact``, given its parts' last references as the table
    gives them) of two phase-4-shaped parts of 2^24, 2^26 and 2^28 entries;
    ``merge_runs`` from its check. Each is fit to bytes = fixed +
    per_entry * n and printed; returns the fits."""
    import torch

    from krust_tpu_torch.ops import table as table_mod

    def measure(make, run):
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        inputs = make()
        torch.cuda.reset_peak_memory_stats()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = run(inputs)
        end.record()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        del out
        return peak, start.elapsed_time(end)

    fits = {}
    rows = []
    for dtype, k, bits in ((torch.int64, 21, 42), (torch.int32, 15, 30)):
        lo = torch.iinfo(dtype).min
        points = []
        for n in (1 << 26, 1 << 28, 1 << 30):
            def make(n=n):
                return [torch.randint(lo, lo + 2**bits, (1 << 25,), generator=g, device=dev,
                                      dtype=dtype) for _ in range(n >> 25)]
            peak, ms = measure(make, table_mod._epoch_concat_sort_rle)
            points.append((n, peak))
            rows.append({"function": "_epoch_concat_sort_rle", "keys": str(dtype), "k": k,
                         "raw_keys": n, "peak_bytes": peak, "ms": ms})
        fits["epoch_flush", str(dtype)] = points
    points = []
    for m in (1 << 24, 1 << 26, 1 << 28):
        def make(m=m):
            parts = _shared_parts(g, torch.int64, dev, m)
            return [(parts[0], parts[1]), (parts[2], parts[3])]
        peak, ms = measure(make, lambda pair: table_mod._merge_compact(pair.pop(0), pair.pop(0)))
        points.append((2 * m, peak))
        rows.append({"function": "_merge_compact", "keys": "torch.int64", "entries": 2 * m,
                     "peak_bytes": peak, "ms": ms})
    fits["part_merge", "torch.int64"] = points
    fits["merge_runs", "torch.int64"] = merge_runs_points
    for r in rows:
        _emit({"phase": 2, "memory": True, **r, "gpu": gpu})
    out = {}
    for (name, keys), points in fits.items():
        fixed, per_entry = _fit(points)
        out[name, keys] = (fixed, per_entry)
        _emit({"phase": 2, "memory_fit": name, "keys": keys, "points": points,
               "fixed_bytes": fixed, "bytes_per_entry": per_entry, "gpu": gpu})
    return out


def _derive_limits(gpu, dev, fits) -> None:
    """The table's entry limits derived from this run's fits, beside the
    constants of ``ops/table.py`` scaled to this card; raises if a
    constant's worst case under this run's fits leaves the budget."""
    import torch

    from krust_tpu_torch.ops import table as table_mod

    total = torch.cuda.mem_get_info(dev)[1]
    budget = table_mod.memory_budget(total)
    f64, f32 = fits["epoch_flush", "torch.int64"], fits["epoch_flush", "torch.int32"]
    merge, runs = fits["part_merge", "torch.int64"], fits["merge_runs", "torch.int64"]
    epoch = table_mod.epoch_entry_limit(dev)
    pending = table_mod.DeviceTable(21, device=dev)._pending_limit
    row = {
        "device_total_bytes": total, "reserve": table_mod.MEM_RESERVE, "budget_bytes": budget,
        "epoch_entry_limit": epoch,
        "epoch_entry_limit_derived": table_mod.fitting_entries(
            f64[0], table_mod.PART_BYTES_PER_ENTRY + f64[1], total),
        "epoch_peak_bytes": table_mod.epoch_peak_bytes(epoch, *f64),
        # int32 keys (k <= 16): a part is 8 B an entry; a figure, not a limit
        "epoch_entry_limit_int32_derived": table_mod.fitting_entries(f32[0], 8 + f32[1], total),
        "pending_entry_limit": pending,
        "pending_entry_limit_derived": table_mod.fitting_entries(*runs, total),
        "pending_peak_bytes": runs[0] + runs[1] * pending,
        "lifetime_merge_entries": table_mod.EPOCH_WINDOW_LIMIT,
        "lifetime_merge_bytes": merge[0] + merge[1] * table_mod.EPOCH_WINDOW_LIMIT,
        "lifetime_merge_bytes_model": table_mod.LIFETIME_MERGE_BYTES,
    }
    _emit({"phase": 2, "limits": row, "gpu": gpu})
    for name in ("epoch_peak_bytes", "pending_peak_bytes", "lifetime_merge_bytes"):
        if row[name] > budget:
            raise AssertionError(f"{name} {row[name]:.0f} > budget {budget:.0f}: {row}")


def _check_large_index(gpu, dev) -> None:
    """K2 and K3 on 2^31 - 2^20 + 7 int64 entries, the size of a table
    lifetime's last merge, where every tile base, tile end and rank past
    2^31 must be 64-bit: outputs checked against their closed form on the
    card in slices (keys = bias + i // 3 with unit weights; the merge of
    the even and the odd keys)."""
    import torch

    from krust_tpu_torch.ops.merge import merge_sorted
    from krust_tpu_torch.ops.rle import rle_compact

    n = (1 << 31) - (1 << 20) + 7
    lo = torch.iinfo(torch.int64).min
    step = 1 << 28

    def check_slices(got, want, what):
        for i in range(0, got.numel(), step):
            j = min(i + step, got.numel())
            if not torch.equal(got[i:j], want(i, j)):
                raise AssertionError(f"{what}: entries {i}..{j} differ from the closed form")

    torch.cuda.empty_cache()
    live = n - 1000  # a sentinel tail
    keys = torch.arange(n, dtype=torch.int64, device=dev).div_(3, rounding_mode="floor").add_(lo)
    keys[live:] = torch.iinfo(torch.int64).max
    o_keys, o_cnt, n_dev = rle_compact(keys, torch.ones(n, dtype=torch.int32, device=dev))
    del keys
    nu = int(n_dev.item())
    if nu != -(-live // 3):
        raise AssertionError(f"K2 at n={n}: n_unique {nu} != {-(-live // 3)}")
    ar = lambda i, j: torch.arange(i, j, dtype=torch.int64, device=dev)  # noqa: E731
    check_slices(o_keys[:nu], lambda i, j: ar(i, j).add_(lo), "K2 keys")
    check_slices(o_cnt[: nu - 1], lambda i, j: torch.full((j - i,), 3, dtype=torch.int32,
                                                         device=dev), "K2 counts")
    if int(o_cnt[nu - 1]) != live - 3 * (nu - 1) or not bool((o_cnt[nu:] == 0).all()):
        raise AssertionError(f"K2 at n={n}: last count or zero tail wrong")
    if not bool((o_keys[nu:] == torch.iinfo(torch.int64).max).all()):
        raise AssertionError(f"K2 at n={n}: sentinel tail wrong")
    del o_keys, o_cnt
    _emit({"phase": 2, "kernel": "rle_compact", "keys": "torch.int64", "n": n,
           "weighted": True, "n_unique": nu, "check": "closed form", "equal": True, "gpu": gpu})

    torch.cuda.empty_cache()
    ma, mb = (n + 1) // 2, n // 2
    a = torch.arange(ma, dtype=torch.int64, device=dev).mul_(2).add_(lo)
    b = torch.arange(mb, dtype=torch.int64, device=dev).mul_(2).add_(lo + 1)
    ac = torch.ones(ma, dtype=torch.int32, device=dev)
    bc = torch.full((mb,), 2, dtype=torch.int32, device=dev)
    out_keys, out_cnt = merge_sorted(a, ac, b, bc)
    del a, b, ac, bc
    check_slices(out_keys, lambda i, j: ar(i, j).add_(lo), "K3 keys")
    check_slices(out_cnt, lambda i, j: ar(i, j).remainder_(2).add_(1).to(torch.int32),
                 "K3 counts")
    del out_keys, out_cnt
    _emit({"phase": 2, "kernel": "merge_sorted", "keys": "torch.int64", "entries": [ma, mb],
           "check": "closed form", "equal": True, "gpu": gpu})
    torch.cuda.empty_cache()


# --- phases 3-5: the main path ---------------------------------------------------


_ACGT = np.frombuffer(b"ACGT", np.uint8)


def write_reads(path, rng, n_bases, genome_len, fastq=False, n_rate=0.0,
                 soft_rate=0.0, lowq_rate=0.0, genome=None):
    """Reads of READ_LEN bases at random positions of a random genome (or of
    ``genome``, base codes 0-3)."""
    if genome is None:
        genome = rng.integers(0, 4, size=genome_len, dtype=np.uint8)
    n_reads = n_bases // READ_LEN
    off = np.arange(READ_LEN)
    with open(path, "wb") as f:
        for r0 in range(0, n_reads, 100_000):
            nr = min(100_000, n_reads - r0)
            starts = rng.integers(0, genome_len - READ_LEN, size=nr)
            seq = _ACGT[genome[starts[:, None] + off]]
            if n_rate:
                seq[rng.random(seq.shape) < n_rate] = ord("N")
            if soft_rate:
                soft = rng.random(seq.shape) < soft_rate
                seq[soft] = seq[soft] + 32  # lowercase
            lines = np.empty((nr, READ_LEN + 1), np.uint8)
            lines[:, :READ_LEN] = seq
            lines[:, READ_LEN] = ord("\n")
            if fastq:
                qual = np.full((nr, READ_LEN + 1), ord("I"), np.uint8)
                qual[:, :READ_LEN][rng.random((nr, READ_LEN)) < lowq_rate] = ord("#")
                qual[:, READ_LEN] = ord("\n")
                head = np.frombuffer(b"@r\n", np.uint8)
                plus = np.frombuffer(b"+\n", np.uint8)
                rec = np.concatenate(
                    [np.broadcast_to(head, (nr, 3)), lines,
                     np.broadcast_to(plus, (nr, 2)), qual], axis=1,
                )
            else:
                head = np.frombuffer(b">r\n", np.uint8)
                rec = np.concatenate([np.broadcast_to(head, (nr, 3)), lines], axis=1)
            f.write(rec.tobytes())


def _native_counts(path, k, min_quality=None):
    from krust_tpu_torch.io import native
    from krust_tpu_torch.io.format import SequenceFormat
    from krust_tpu_torch.io.reader import parse_to_streams, read_input_bytes
    from krust_tpu_torch.models.engines import NativeEngine

    if not native.available():
        raise AssertionError("the native C++ core did not build")
    streams = parse_to_streams(read_input_bytes(path), SequenceFormat.AUTO.resolve(path))
    return NativeEngine().count(streams, k, min_quality)


def _port_counts(path, k, min_quality=None, config=None):
    from krust_tpu_torch import api
    from krust_tpu_torch.io.input import Input

    return api.count_with_input(Input.from_path(path), k, min_quality=min_quality,
                                config=config)


def _assert_equal(got, exp, what):
    if not (np.array_equal(got.codes, exp.codes) and np.array_equal(got.counts, exp.counts)):
        raise AssertionError(f"{what}: port table != native core table "
                             f"({got.distinct} vs {exp.distinct} distinct)")


def _counters():
    from krust_tpu_torch.ops.codec import encode_dense
    from krust_tpu_torch.ops.fused_codec import encode_windows
    from krust_tpu_torch.ops.histogram import count_histogram
    from krust_tpu_torch.ops.merge import merge_sorted, merge_sorted_keys
    from krust_tpu_torch.ops.rle import rle_compact

    return {"encode_windows": encode_windows, "rle_compact": rle_compact,
            "merge_sorted": merge_sorted, "encode_dense": encode_dense,
            "merge_sorted_keys": merge_sorted_keys, "count_histogram": count_histogram}


def _launches() -> dict:
    return {name: fn.launches for name, fn in _counters().items()}


def _zero_launches() -> None:
    for fn in _counters().values():
        fn.launches = 0


def _phase3(rng, gpu, tmp, keep=False):
    """bench.py's workload, timed once; with ``keep`` the file and the
    native core's table stay for phase 8: returns (path, table)."""
    import torch

    from krust_tpu_torch.models.engines import BatchEngine, select_engine
    from krust_tpu_torch.utils.config import EngineConfig

    engine = select_engine(EngineConfig())
    if not isinstance(engine, BatchEngine) or engine.device.type != "cuda":
        raise AssertionError(f"KRUST_ENGINE=device picked {engine!r}")
    path = os.path.join(tmp, "reads.fa")
    t0 = time.perf_counter()
    write_reads(path, rng, MAIN_BASES, GENOME)
    gen_s = time.perf_counter() - t0
    before = _launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    got = _port_counts(path, 21)
    sec = time.perf_counter() - t0
    after = _launches()
    runs = [{"seconds": sec, "mbases_per_s": MAIN_BASES / 1e6 / sec,
             "peak_device_bytes": torch.cuda.max_memory_allocated(),
             "launches": {n: after[n] - before[n] for n in after}}]
    if runs[0]["launches"]["encode_windows"] <= 0 or runs[0]["launches"]["rle_compact"] <= 0:
        raise AssertionError(f"phase 3 skipped a kernel: {runs[0]['launches']}")
    t0 = time.perf_counter()
    exp = _native_counts(path, 21)
    native_s = time.perf_counter() - t0
    _assert_equal(got, exp, "phase 3 k=21")
    _emit({"phase": 3, "k": 21, "bases": MAIN_BASES, "read_len": READ_LEN,
           "genome": GENOME, "distinct": got.distinct, "total": got.total,
           "equal_to_native": True, "data_gen_s": gen_s, "runs": runs,
           "native_core_s": native_s, "gpu": gpu})
    if keep:
        return path, exp
    os.unlink(path)
    return None


def _write_main4(rng, tmp):
    """Phase 4's file: 1.25 default epochs of reads at 32x; returns (path,
    bases, genome, epoch entries)."""
    import torch

    from krust_tpu_torch.ops.table import epoch_entry_limit

    limit = epoch_entry_limit(torch.device("cuda", 0))
    bases = limit * 5 // 4 // READ_LEN * READ_LEN
    genome = bases // 32
    path = os.path.join(tmp, "reads_main.fa")
    write_reads(path, rng, bases, genome)
    return path, bases, genome, limit


def _device_budget(dev) -> float:
    """The device bytes the table's limits are derived to stay within."""
    import torch

    from krust_tpu_torch.ops.table import memory_budget

    return memory_budget(torch.cuda.mem_get_info(dev)[1])


def _main4_file(rng, tmp):
    """Phase 4's file and its native-core table, made anew."""
    path = _write_main4(rng, tmp)[0]
    return path, _native_counts(path, 21)


def _phase4(rng, gpu, tmp, keep=False):
    """The clean main path at the default epoch size; returns its launch
    counts and, with ``keep``, its file and the native core's table (else
    None)."""
    import torch

    dev = torch.device("cuda", 0)
    path, bases, genome, limit = _write_main4(rng, tmp)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    t0 = time.perf_counter()
    got = _port_counts(path, 21)
    sec = time.perf_counter() - t0
    launches = _launches()
    peak = torch.cuda.max_memory_allocated()
    missing = [n for n in ("encode_windows", "rle_compact", "merge_sorted")
               if launches[n] <= 0]
    if missing:
        raise AssertionError(f"main path never launched: {missing} ({launches})")
    budget = _device_budget(dev)
    if peak > budget:
        raise AssertionError(f"phase 4 device peak {peak} > budget {budget:.0f}")
    t0 = time.perf_counter()
    exp = _native_counts(path, 21)
    native_s = time.perf_counter() - t0
    _assert_equal(got, exp, "phase 4 k=21")
    _emit({"phase": 4, "k": 21, "bases": bases, "read_len": READ_LEN, "genome": genome,
           "epoch_entries": limit, "distinct": got.distinct, "total": got.total,
           "equal_to_native": True, "seconds": sec, "mbases_per_s": bases / 1e6 / sec,
           "peak_device_bytes": peak, "device_budget_bytes": budget,
           "device_total_bytes": torch.cuda.mem_get_info(dev)[1],
           "launches": launches, "native_core_s": native_s, "gpu": gpu})
    if keep:
        return launches, (path, exp)
    os.unlink(path)
    return launches, None


def _phase5(rng, gpu, tmp):
    from krust_tpu_torch.utils.config import EngineConfig

    path = os.path.join(tmp, "reads64.fa")
    write_reads(path, rng, 64_000_000, GENOME)
    os.environ["KRUST_EPOCH_ENTRIES"] = str(1 << 22)
    try:
        for k in (16, 31):
            before = _launches()
            t0 = time.perf_counter()
            got = _port_counts(path, k, config=EngineConfig(batch_rows=1024))
            sec = time.perf_counter() - t0
            after = _launches()
            merges = after["merge_sorted"] - before["merge_sorted"]
            if merges <= 0:
                raise AssertionError(f"k={k}: no part merge ran")
            _assert_equal(got, _native_counts(path, k), f"phase 5 k={k}")
            _emit({"phase": 5, "k": k, "bases": 64_000_000, "epoch_entries": 1 << 22,
                   "merge_launches": merges, "distinct": got.distinct,
                   "equal_to_native": True, "seconds": sec, "gpu": gpu})
    finally:
        del os.environ["KRUST_EPOCH_ENTRIES"]
    os.unlink(path)


def _phase6(rng, gpu, tmp):
    from krust_tpu_torch.output import OutputFormat, format_packed_counts

    path = os.path.join(tmp, "reads.fq")
    write_reads(path, rng, 8_000_000, 1_000_000, fastq=True, n_rate=0.004,
                 soft_rate=0.05, lowq_rate=0.01)
    for k in (1, 5, 17, 24, 32):
        before = _launches()
        got = _port_counts(path, k, min_quality=20)
        after = _launches()
        _assert_equal(got, _native_counts(path, k, 20), f"phase 6 k={k}")
        _emit({"phase": 6, "k": k, "bases": 8_000_000, "min_quality": 20,
               "distinct": got.distinct, "equal_to_native": True,
               "launches": {n: after[n] - before[n] for n in after}})
    small = os.path.join(tmp, "small.fq")
    write_reads(small, rng, 250_000, 100_000, fastq=True, n_rate=0.004,
                 soft_rate=0.05, lowq_rate=0.01)
    cli = subprocess.run(
        [sys.executable, "-m", "krust_tpu_torch", "24", small, "-f", "tsv", "-q",
         "-Q", "20"],
        capture_output=True, check=True, env=dict(os.environ, KRUST_ENGINE="device"),
    )
    exp = _native_counts(small, 24, 20)
    want = format_packed_counts(exp.codes, exp.counts, 24, OutputFormat.TSV, 1)
    if cli.stdout != want:
        raise AssertionError("CLI tsv output != native core")
    _emit({"phase": 6, "cli": "python -m krust_tpu_torch 24 small.fq -f tsv -q -Q 20",
           "lines": cli.stdout.count(b"\n"), "equal_to_native": True})


def _phase7(rng, gpu, tmp) -> dict:
    """The dense path at full size; returns the launch counts of its first
    count."""
    import torch

    from krust_tpu_torch.io import packer
    from krust_tpu_torch.io.format import SequenceFormat
    from krust_tpu_torch.io.reader import parse_to_streams, read_input_bytes
    from krust_tpu_torch.kmer import INVALID_CODE
    from krust_tpu_torch.models.engines import BatchEngine
    from krust_tpu_torch.utils.config import EngineConfig

    k, q = 21, 20
    path = os.path.join(tmp, "dirty_main.fq")
    t0 = time.perf_counter()
    write_reads(path, rng, MAIN_BASES, GENOME, fastq=True, n_rate=0.02, lowq_rate=0.03)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    exp = _native_counts(path, k, q)
    native_s = time.perf_counter() - t0

    def dense_only(launches, what):
        if (launches["encode_dense"] <= 0 or launches["rle_compact"] <= 0
                or launches["encode_windows"] != 0):
            raise AssertionError(f"{what} did not take the dense path: {launches}")

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    t0 = time.perf_counter()
    got = _port_counts(path, k, min_quality=q)
    sec = time.perf_counter() - t0
    first = _launches()
    dense_only(first, "phase 7")
    _assert_equal(got, exp, "phase 7 k=21")
    runs = [{"seconds": sec, "mbases_per_s": MAIN_BASES / 1e6 / sec,
             "peak_device_bytes": torch.cuda.max_memory_allocated(), "launches": first}]

    # one parse of the same file: its invalid share, the dense packer's host
    # time, and the stream timed on both device routes
    streams = parse_to_streams(read_input_bytes(path), SequenceFormat.AUTO.resolve(path))
    thr = q + 33
    invalid_share = float(np.mean((streams.codes >= INVALID_CODE) | (streams.qual < thr)))
    t0 = time.perf_counter()
    n_batches = sum(1 for _ in packer.pack_buffer_2bit(streams.codes, streams.qual, k, thr,
                                                        4096, 8192))
    pack_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    scan = packer.flat_scan(streams.codes, streams.qual, thr, streams.codes.shape[0])
    scan_s = time.perf_counter() - t0
    engine = BatchEngine(EngineConfig())
    scan_stream = packer.scan_stream

    def flat_route(codes, qual, t, max_inv, *a, **kw):
        """The route scan without its 1/32 limit (a measurement only)."""
        return scan_stream(codes, qual, t, codes.shape[0] if max_inv >= 0 else max_inv, *a,
                           **kw)

    route_s = {"dense": [], "flat": []}
    for name in ("dense", "flat", "flat", "dense"):
        _zero_launches()
        if name == "flat":
            packer.scan_stream = flat_route
        try:
            t0 = time.perf_counter()
            got = engine.count(streams, k, q)
            route_s[name].append(time.perf_counter() - t0)
        finally:
            packer.scan_stream = scan_stream
        launches = _launches()
        codec = "encode_dense" if name == "dense" else "encode_windows"
        other = "encode_windows" if name == "dense" else "encode_dense"
        if launches[codec] <= 0 or launches[other] != 0:
            raise AssertionError(f"route {name}: {launches}")
        _assert_equal(got, exp, f"phase 7 route {name}")
    _emit({"phase": 7, "k": k, "min_quality": q, "bases": MAIN_BASES, "read_len": READ_LEN,
           "genome": GENOME, "invalid_share": invalid_share, "distinct": exp.distinct,
           "total": exp.total, "equal_to_native": True, "data_gen_s": gen_s, "runs": runs,
           "native_core_s": native_s, "dense_pack_s": pack_s,
           "pack_buffer_2bit_batches": n_batches, "route_scan_unlimited_s": scan_s,
           "invalid_positions": int(scan[1].shape[0]),
           "route_count_s": route_s, "gpu": gpu})
    del streams, scan
    os.unlink(path)

    dirty = os.path.join(tmp, "dirty.fq")
    write_reads(dirty, rng, 8_000_000, 1_000_000, fastq=True, n_rate=0.05,
                soft_rate=0.05, lowq_rate=0.02)
    cases = [(kk, None) for kk in (1, 5, 16, 17, 24, 32)] + [(21, 8)]
    for kk, w in cases:
        config = EngineConfig(block_windows=w) if w else None
        before = _launches()
        got = _port_counts(dirty, kk, min_quality=q, config=config)
        after = _launches()
        launches = {n: after[n] - before[n] for n in after}
        dense_only(launches, f"phase 7 dirty k={kk}")
        _assert_equal(got, _native_counts(dirty, kk, q), f"phase 7 dirty k={kk}")
        _emit({"phase": 7, "k": kk, "block_windows": w or 4096, "bases": 8_000_000,
               "min_quality": q, "invalid_share": "~0.07", "distinct": got.distinct,
               "equal_to_native": True, "launches": launches})
    os.unlink(dirty)
    return first


def _main_file(rng, tmp, main):
    """Phase 3's file and its native-core table: ``main`` when phase 3 kept
    them, else made anew."""
    if main is not None:
        return main
    path = os.path.join(tmp, "reads.fa")
    write_reads(path, rng, MAIN_BASES, GENOME)
    return path, _native_counts(path, 21)


def _phase8(rng, gpu, tmp, main):
    """The LSM table path on the card: phase 3's workload (its file and
    native-core table, made anew when phase 3 did not run), then int32 keys
    and the dense route. Returns phase 3's file and table for phase 9."""
    import torch

    from krust_tpu_torch.utils.config import EngineConfig

    lsm = EngineConfig(use_epoch_sort=False)
    main = _main_file(rng, tmp, main)
    path, exp = main
    runs = []
    for _ in range(2):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _zero_launches()
        t0 = time.perf_counter()
        got = _port_counts(path, 21, config=lsm)
        sec = time.perf_counter() - t0
        launches = _launches()
        if (launches["encode_windows"] <= 0 or launches["rle_compact"] <= 0
                or launches["merge_sorted"] != 0):
            raise AssertionError(f"phase 8 did not take the LSM table path: {launches}")
        _assert_equal(got, exp, "phase 8 k=21")
        runs.append({"seconds": sec, "mbases_per_s": MAIN_BASES / 1e6 / sec,
                     "peak_device_bytes": torch.cuda.max_memory_allocated(),
                     "launches": launches})
    _emit({"phase": 8, "table": "DeviceTable", "k": 21, "bases": MAIN_BASES,
           "read_len": READ_LEN, "genome": GENOME, "distinct": exp.distinct,
           "total": exp.total, "equal_to_native": True, "runs": runs, "gpu": gpu})

    cases = [("reads64.fa", 64_000_000, GENOME, 16, None, {}),
             ("dirty8.fq", 8_000_000, 1_000_000, 21, 20,
              dict(fastq=True, n_rate=0.05, soft_rate=0.05, lowq_rate=0.02))]
    for name, bases, genome, k, q, rates in cases:
        path = os.path.join(tmp, name)
        write_reads(path, rng, bases, genome, **rates)
        _zero_launches()
        t0 = time.perf_counter()
        got = _port_counts(path, k, min_quality=q, config=lsm)
        sec = time.perf_counter() - t0
        launches = _launches()
        codec = "encode_dense" if q else "encode_windows"
        other = "encode_windows" if q else "encode_dense"
        if (launches[codec] <= 0 or launches[other] != 0 or launches["rle_compact"] <= 0
                or launches["merge_sorted"] != 0):
            raise AssertionError(f"phase 8 k={k}: {launches}")
        _assert_equal(got, _native_counts(path, k, q), f"phase 8 k={k}")
        _emit({"phase": 8, "table": "DeviceTable", "k": k, "bases": bases, "min_quality": q,
               "distinct": got.distinct, "equal_to_native": True, "seconds": sec,
               "launches": launches, "gpu": gpu})
        os.unlink(path)
    return main


def _phase9(rng, gpu, tmp, main, main4):
    """The sharded path: phase 3's file, then a dirty FASTQ, each with no
    process group (a mesh of every card) and inside a one-rank NCCL group;
    then one process over a mesh of slots (:func:`_phase9_mesh`). Returns
    phase 4's file and table (made anew when phase 4 did not keep them)
    and the launches of the mesh's count of it."""
    import torch
    import torch.distributed as dist

    from krust_tpu_torch import api
    from krust_tpu_torch.parallel.mesh import init_distributed
    from krust_tpu_torch.utils import tracing

    main = _main_file(rng, tmp, main)
    main4 = main4 or _main4_file(rng, tmp)
    path, exp = main
    n_cards = torch.cuda.device_count()
    dirty = os.path.join(tmp, "dirty9.fq")
    write_reads(dirty, rng, 8_000_000, 1_000_000, fastq=True, n_rate=0.05,
                soft_rate=0.05, lowq_rate=0.02)
    exp_dirty = _native_counts(dirty, 21, 20)
    seen: dict = {}

    def collect(kind, name, fields):
        if name in ("sharded_exchange", "shard_sizes", "pull_table"):
            seen.setdefault(name, []).append(fields)

    def count(file, q, table, group, codec, other, entry="sharded"):
        seen.clear()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _zero_launches()
        t0 = time.perf_counter()
        if entry == "sharded":
            got = api.count_kmers_sharded_result(file, 21, min_quality=q)
        else:
            got = _port_counts(file, 21, min_quality=q)
        sec = time.perf_counter() - t0
        launches = _launches()
        if launches[codec] <= 0 or launches["rle_compact"] <= 0 or launches[other] != 0:
            raise AssertionError(f"phase 9 {group} {entry} {file}: {launches}")
        # no group: the mesh is every card, so one card exchanges nothing
        exchanged = group == "nccl" or (entry == "sharded" and n_cards >= 2)
        if bool(seen.get("sharded_exchange")) != exchanged:
            raise AssertionError(f"phase 9 {group}: exchanges {seen}")
        if entry == "sharded" and group == "none" and any(
                len(e["sizes"]) != n_cards for e in seen["shard_sizes"]):
            raise AssertionError(f"phase 9: the default mesh is not every card: {seen}")
        _assert_equal(got, table, f"phase 9 {group} {entry} {os.path.basename(file)}")
        return {"entry": entry, "seconds": sec,
                "peak_device_bytes": torch.cuda.max_memory_allocated(),
                "launches": launches, "exchanges": seen.get("sharded_exchange", []),
                "shard_sizes": [e["sizes"] for e in seen.get("shard_sizes", [])]}

    tracing.add_collector(collect)
    try:
        for group in ("none", "nccl"):
            if group == "nccl":
                init_distributed(f"file://{os.path.join(tmp, 'pg')}", rank=0, world_size=1)
            try:
                order = ("plain", "sharded") if group == "none" else ("sharded",)
                runs = [count(path, None, exp, group, "encode_windows", "encode_dense", entry)
                        for entry in order]
                for r in runs:
                    r["mbases_per_s"] = MAIN_BASES / 1e6 / r["seconds"]
                _emit({"phase": 9, "process_group": group, "k": 21, "bases": MAIN_BASES,
                       "read_len": READ_LEN, "genome": GENOME, "distinct": exp.distinct,
                       "equal_to_native": True, "runs": runs, "gpu": gpu})
                run = count(dirty, 20, exp_dirty, group, "encode_dense", "encode_windows")
                _emit({"phase": 9, "process_group": group, "k": 21, "bases": 8_000_000,
                       "min_quality": 20, "invalid_share": "~0.07",
                       "distinct": exp_dirty.distinct, "equal_to_native": True, **run,
                       "gpu": gpu})
                if group == "nccl":
                    group_slots = _phase9_group_slots(gpu, main, (dirty, exp_dirty), seen)
            finally:
                if group == "nccl":
                    dist.destroy_process_group()
        launches = _phase9_mesh(gpu, main, main4, (dirty, exp_dirty), seen)
    finally:
        tracing.remove_collector(collect)
    _phase9_two_ranks(gpu, tmp, main, (dirty, exp_dirty))
    os.unlink(dirty)
    return main4, launches, group_slots


def _phase9_group_slots(gpu, main, dirty, seen) -> dict:
    """Inside the one-rank NCCL group: a mesh of 4 slots of cuda:0 counts
    phase 3's file at k = 21 (the flat route) and the dirty FASTQ at -Q 20
    (the dense route) through ``count_kmers_sharded_result``, the counters
    at 0 just before each. K1 or K4, K2 and K3 must launch; every exchange
    lists 4 shard sizes and sends nothing between processes; the table
    equals the native core's. Returns the launches of both counts, summed."""
    import torch

    from krust_tpu_torch import api
    from krust_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(devices=[torch.device("cuda", 0)] * 4)
    if mesh.group is None or (mesh.size, mesh.world) != (4, 1):
        raise AssertionError(f"phase 9: not a one-rank group of 4 slots: {mesh}")
    total: dict = {}
    for what, (file, exp), q, codec in (("phase 3's file", main, None, "encode_windows"),
                                        ("dirty FASTQ", dirty, 20, "encode_dense")):
        other = "encode_dense" if codec == "encode_windows" else "encode_windows"
        seen.clear()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _zero_launches()
        t0 = time.perf_counter()
        got = api.count_kmers_sharded_result(file, 21, min_quality=q, mesh=mesh)
        sec = time.perf_counter() - t0
        launches = _launches()
        tag = f"phase 9 nccl, 4 slots, {what}"
        if (min(launches[n] for n in (codec, "rle_compact", "merge_sorted")) <= 0
                or launches[other] != 0):
            raise AssertionError(f"{tag}: a kernel of the path did not launch: {launches}")
        _assert_equal(got, exp, tag)
        exchanges = seen.get("sharded_exchange", [])
        sizes = [e["sizes"] for e in seen.get("shard_sizes", [])]
        if (not exchanges or len(sizes) != len(exchanges) or any(len(z) != 4 for z in sizes)
                or any(e["process_bytes"] for e in exchanges)):
            raise AssertionError(f"{tag}: exchanges {exchanges}, shard sizes {sizes}")
        _emit({"phase": 9, "process_group": "nccl", "mesh": "4 slots on cuda:0",
               "count": what, "k": 21, "min_quality": q, "distinct": got.distinct,
               "equal_to_native": True, "seconds": sec,
               "peak_device_bytes": torch.cuda.max_memory_allocated(), "launches": launches,
               "exchange_s": [e["elapsed_s"] for e in exchanges],
               "wire_bytes": [e["wire_bytes"] for e in exchanges],
               "process_bytes": [e["process_bytes"] for e in exchanges],
               "sent_bytes": [e["sent_bytes"] for e in exchanges],
               "shard_sizes": sizes, "gpu": gpu})
        for n, v in launches.items():
            total[n] = total.get(n, 0) + v
    return total


#: one rank of phase 9's two-rank gloo group on the one card: argv is the
#: rank, the group's init file and a JSON spec (each rank's file, quality
#: and result paths). It first asks gloo for an ``all_to_all_single`` of
#: CUDA tensors; where gloo refuses, it writes the error and counts
#: nothing. Else it counts its file over 2 slots of cuda:0 with the
#: counters at 0 just before and writes its table, seconds, launches and
#: exchanges.
_RANK_CHILD = r"""
import json, sys, time
from datetime import timedelta
import numpy as np
import torch
import torch.distributed as dist
from krust_tpu_torch import api
from krust_tpu_torch.ops.codec import encode_dense
from krust_tpu_torch.ops.fused_codec import encode_windows
from krust_tpu_torch.ops.merge import merge_sorted
from krust_tpu_torch.ops.rle import rle_compact
from krust_tpu_torch.parallel.mesh import init_distributed, make_mesh
from krust_tpu_torch.utils import tracing

rank, spec = int(sys.argv[1]), json.loads(sys.argv[3])
init_distributed("file://" + sys.argv[2], rank=rank, world_size=2, backend="gloo",
                 timeout=timedelta(seconds=120))
out = {"rank": rank}
try:
    probe = torch.full((2,), rank, dtype=torch.int64, device="cuda:0")
    try:
        dist.all_to_all_single(torch.empty_like(probe), probe)
        out["gloo_takes_cuda"] = True
    except RuntimeError as e:
        out.update(gloo_takes_cuda=False, error=str(e).strip().splitlines()[0])
    if out["gloo_takes_cuda"]:
        fns = {"encode_windows": encode_windows, "encode_dense": encode_dense,
               "rle_compact": rle_compact, "merge_sorted": merge_sorted}
        ex = []
        tracing.add_collector(
            lambda kind, name, f: ex.append(f) if name == "sharded_exchange" else None)
        mesh = make_mesh(devices=["cuda:0"] * 2)
        for fn in fns.values():
            fn.launches = 0
        t0 = time.perf_counter()
        got = api.count_kmers_sharded_result(spec["files"][rank], 21,
                                             min_quality=spec["q"][rank], mesh=mesh)
        out.update(seconds=time.perf_counter() - t0, mesh_size=mesh.size,
                   launches={n: fn.launches for n, fn in fns.items()}, exchanges=ex)
        np.savez(spec["tables"][rank], codes=got.codes, counts=got.counts)
finally:
    dist.destroy_process_group()
json.dump(out, open(spec["out"][rank], "w"))
"""


def _sum_tables(a, b):
    """Two (codes, counts) tables as one, the counts of shared codes summed."""
    codes = np.concatenate([a[0], b[0]])
    uniq, inv = np.unique(codes, return_inverse=True)
    counts = np.zeros(uniq.shape[0], np.uint64)
    np.add.at(counts, inv, np.concatenate([a[1], b[1]]))
    return uniq, counts


def _phase9_two_ranks(gpu, tmp, main, dirty) -> None:
    """Two ranks of a gloo group in two children on the one card (NCCL
    refuses two ranks on one card), each over 2 slots of cuda:0: rank 0
    counts phase 3's file (the flat route), rank 1 the dirty FASTQ at -Q 20
    (the dense route), so the ranks' routes differ. Where gloo takes CUDA
    tensors, the tables must be disjoint, each rank's keys owned by its own
    two global slots, their union equal to the two native tables summed,
    and each rank's codec kernel, K2 and K3 launched; where it does not,
    the line records gloo's error."""
    import torch

    from krust_tpu_torch.ops.keys import codes_to_keys
    from krust_tpu_torch.parallel.sharded import _owner_of

    (path3, exp3), (path_d, exp_d) = main, dirty
    spec = {"files": [path3, path_d], "q": [None, 20],
            "tables": [os.path.join(tmp, f"rank{r}.npz") for r in range(2)],
            "out": [os.path.join(tmp, f"rank{r}.json") for r in range(2)]}
    init = os.path.join(tmp, "pg2")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-c", _RANK_CHILD, str(r), init, json.dumps(spec)],
                              cwd=os.path.dirname(os.path.abspath(__file__)))
             for r in range(2)]
    try:
        rcs = [p.wait(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    if rcs != [0, 0]:
        raise AssertionError(f"phase 9 two ranks: children exited {rcs}")
    outs = []
    for path in spec["out"]:
        with open(path) as f:
            outs.append(json.load(f))
    if not outs[0]["gloo_takes_cuda"]:
        _emit({"phase": 9, "two_ranks_on_one_card": "not run: gloo refuses CUDA tensors in "
               "all_to_all_single", "error": outs[0]["error"], "child_seconds": wall,
               "gpu": gpu})
        return
    tables = [np.load(path) for path in spec["tables"]]
    for r, (t, o, codec) in enumerate(zip(tables, outs, ("encode_windows", "encode_dense"))):
        keys = torch.from_numpy(codes_to_keys(t["codes"], 21))
        if not torch.all(_owner_of(keys, 4) // 2 == r):
            raise AssertionError(f"phase 9 two ranks: rank {r} holds another rank's key")
        if min(o["launches"][n] for n in (codec, "rle_compact", "merge_sorted")) <= 0:
            raise AssertionError(f"phase 9 two ranks: rank {r} launches {o['launches']}")
    codes = np.concatenate([t["codes"] for t in tables])
    counts = np.concatenate([t["counts"] for t in tables])
    order = np.argsort(codes)
    exp_codes, exp_counts = _sum_tables((exp3.codes, exp3.counts), (exp_d.codes, exp_d.counts))
    if not (np.array_equal(codes[order], exp_codes) and np.array_equal(counts[order], exp_counts)):
        raise AssertionError(f"phase 9 two ranks: union of {codes.shape[0]} entries != the "
                             f"native tables' {exp_codes.shape[0]}")
    _emit({"phase": 9, "two_ranks_on_one_card": "gloo, 2 slots of cuda:0 a rank",
           "files": ["phase 3's file, k = 21", "dirty FASTQ, k = 21, -Q 20"],
           "distinct": int(exp_codes.shape[0]), "union_equal_to_native": True,
           "shards_disjoint": True, "child_seconds": wall,
           "ranks": [{k: o[k] for k in ("seconds", "launches", "mesh_size")}
                     | {"exchange_s": [e["elapsed_s"] for e in o["exchanges"]],
                        "wire_bytes": [e["wire_bytes"] for e in o["exchanges"]],
                        "process_bytes": [e["process_bytes"] for e in o["exchanges"]]}
                     for o in outs], "gpu": gpu})


def _phase9_mesh(gpu, main, main4, dirty, seen) -> dict:
    """One process counting over a mesh of slots: 4 slots on cuda:0 (and
    every card, when there are two or more) count phase 4's file (k = 21,
    the flat route, the window limit at 2^30 so that the slots exchange
    twice), the dirty FASTQ at -Q 20 (the dense route) and phase 3's file
    at k = 15 (int32 keys), each through ``count_kmers_sharded_result``
    with the counters at 0 just before. The table must equal the native
    core's (so no lifetime's table held a key twice: the shards were
    disjoint), each exchange's shard sizes must sum to the entries pulled,
    and after one exchange each shard's size must be the number of the
    table's keys its hash owns. Then 3 and 8 slots of cuda:0
    (:func:`_phase9_odd_slots`) and ``dryrun_multichip`` over every card.
    Returns the launches of phase 4's file on the 4 slots."""
    import contextlib
    import io

    import torch

    from krust_tpu_torch import api
    from krust_tpu_torch.entry import dryrun_multichip
    from krust_tpu_torch.ops import table as table_mod
    from krust_tpu_torch.ops.keys import codes_to_keys
    from krust_tpu_torch.parallel.mesh import make_mesh
    from krust_tpu_torch.parallel.sharded import _owner_of

    (path3, exp3), (path4, exp4) = main, main4
    t0 = time.perf_counter()
    exp15 = _native_counts(path3, 15)
    native15_s = time.perf_counter() - t0
    cards = torch.cuda.device_count()
    meshes = [("4 slots on cuda:0", make_mesh(devices=[torch.device("cuda", 0)] * 4))]
    if cards >= 2:
        meshes.append((f"{cards} cards", make_mesh()))
        _emit({"phase": 9, "peer_access": [
            [i == j or torch.cuda.can_device_access_peer(i, j) for j in range(cards)]
            for i in range(cards)], "gpu": gpu})
    counts = [("phase 4's file", path4, 21, None, exp4, "encode_windows", MESH_WINDOW_LIMIT),
              ("dirty FASTQ", dirty[0], 21, 20, dirty[1], "encode_dense", None),
              ("phase 3's file", path3, 15, None, exp15, "encode_windows", None)]
    launches4 = {}
    for name, mesh in meshes:
        devices = sorted(set(mesh.devices), key=str)
        for what, file, k, q, exp, codec, window_limit in counts:
            other = "encode_dense" if codec == "encode_windows" else "encode_windows"
            seen.clear()
            torch.cuda.empty_cache()
            for d in devices:
                torch.cuda.reset_peak_memory_stats(d)
            limit = table_mod.EPOCH_WINDOW_LIMIT
            table_mod.EPOCH_WINDOW_LIMIT = window_limit or limit
            _zero_launches()
            try:
                t0 = time.perf_counter()
                got = api.count_kmers_sharded_result(file, k, min_quality=q, mesh=mesh)
                sec = time.perf_counter() - t0
            finally:
                table_mod.EPOCH_WINDOW_LIMIT = limit
            launches = _launches()
            tag = f"phase 9 {name}, {what}"
            if (min(launches[n] for n in (codec, "rle_compact", "merge_sorted")) <= 0
                    or launches[other] != 0):
                raise AssertionError(f"{tag}: a kernel of the path did not launch: {launches}")
            _assert_equal(got, exp, tag)
            exchanges = seen.get("sharded_exchange", [])
            sizes = [e["sizes"] for e in seen.get("shard_sizes", [])]
            pulled = [e["entries"] for e in seen.get("pull_table", [])]
            if len(exchanges) < (2 if window_limit else 1) or len(sizes) != len(exchanges):
                raise AssertionError(f"{tag}: {len(exchanges)} exchanges")
            if any(len(z) != mesh.size for z in sizes) or [sum(z) for z in sizes] != pulled:
                raise AssertionError(f"{tag}: shard sizes {sizes}, pulled {pulled}")
            if len(sizes) == 1:
                keys = torch.from_numpy(codes_to_keys(got.codes, k))
                owned = torch.bincount(_owner_of(keys, mesh.size), minlength=mesh.size)
                if owned.tolist() != sizes[0]:
                    raise AssertionError(f"{tag}: shards {sizes[0]}, owners {owned.tolist()}")
            peaks = {str(d): torch.cuda.max_memory_allocated(d) for d in devices}
            budget = _device_budget(devices[0])
            if max(peaks.values()) > budget:
                raise AssertionError(f"{tag}: device peak {peaks} > budget {budget:.0f}")
            row = {"phase": 9, "mesh": name, "slots": [str(d) for d in mesh.devices],
                   "count": what, "k": k, "min_quality": q,
                   "file_bytes": os.path.getsize(file), "window_limit": window_limit,
                   "distinct": got.distinct, "equal_to_native": True, "seconds": sec,
                   "peak_device_bytes": peaks, "launches": launches,
                   "exchanges": len(exchanges),
                   "exchange_s": [e["elapsed_s"] for e in exchanges],
                   "wire_bytes": [e["wire_bytes"] for e in exchanges],
                   "sent_bytes": [e["sent_bytes"] for e in exchanges],
                   "shard_sizes": sizes, "shards_disjoint": True, "gpu": gpu}
            if k == 15:
                row["native_core_s"] = native15_s
            _emit(row)
            if name == meshes[0][0] and window_limit:
                launches4 = launches
    for slots, k, exp in ((3, 21, exp3), (8, 15, exp15)):
        _phase9_odd_slots(gpu, path3, k, exp, slots, seen)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        dryrun_multichip(cards)
    _emit({"phase": 9, "dryrun_multichip": out.getvalue().strip(), "gpu": gpu})
    return launches4


def _np_owner(codes: np.ndarray, n: int) -> np.ndarray:
    """The owner slot of uint64 codes among n, in numpy and independent of
    the port: krust_tpu's hash of the code's 32-bit halves (``(hi * MIX1)
    ^ (lo * MIX2)``, two xorshift-multiply rounds, all mod 2^32), mod n."""
    m32, mix1, mix2 = np.uint64(0xFFFFFFFF), np.uint64(0x9E3779B1), np.uint64(0x85EBCA77)
    hi, lo = codes >> np.uint64(32), codes & m32
    h = ((hi * mix1) & m32) ^ ((lo * mix2) & m32)
    h ^= h >> np.uint64(16)
    h = (h * mix1) & m32
    h ^= h >> np.uint64(13)
    return h % np.uint64(n)


def _phase9_odd_slots(gpu, path, k, exp, slots, seen) -> None:
    """Phase 3's file over ``slots`` slots of cuda:0 (3 and 8: slot counts
    that do not divide 4) through ``count_kmers_sharded_result``, the
    counters at 0 just before: K1, K2 and K3 must launch, the table must
    equal the native core's, and each slot's shard (read from the
    exchange, one lifetime: one exchange) must be the native table's
    entries that :func:`_np_owner` gives that slot."""
    import torch

    from krust_tpu_torch import api
    from krust_tpu_torch.ops.keys import keys_to_codes
    from krust_tpu_torch.parallel import sharded as sharded_mod
    from krust_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(devices=[torch.device("cuda", 0)] * slots)
    shards = []
    real = sharded_mod._exchange

    def exchange(parts, mesh_, k_):
        out = real(parts, mesh_, k_)
        shards.append([(keys_to_codes(keys[:m].cpu().numpy(), k_),
                        cnt[:m].cpu().numpy().astype(np.uint64)) for keys, cnt, m in out])
        return out

    seen.clear()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    sharded_mod._exchange = exchange
    _zero_launches()
    try:
        t0 = time.perf_counter()
        got = api.count_kmers_sharded_result(path, k, mesh=mesh)
        sec = time.perf_counter() - t0
    finally:
        sharded_mod._exchange = real
    launches = _launches()
    tag = f"phase 9 {slots} slots on cuda:0, phase 3's file, k={k}"
    if (min(launches[n] for n in ("encode_windows", "rle_compact", "merge_sorted")) <= 0
            or launches["encode_dense"] != 0):
        raise AssertionError(f"{tag}: a kernel of the path did not launch: {launches}")
    _assert_equal(got, exp, tag)
    if len(shards) != 1 or len(shards[0]) != slots:
        raise AssertionError(f"{tag}: {len(shards)} exchanges")
    owner = _np_owner(exp.codes, slots)
    for g, (codes, counts) in enumerate(shards[0]):
        mine = owner == g
        if not (np.array_equal(codes, exp.codes[mine])
                and np.array_equal(counts, exp.counts[mine].astype(np.uint64))):
            raise AssertionError(f"{tag}: slot {g}'s shard is not its owner's cut")
    sizes = [e["sizes"] for e in seen.get("shard_sizes", [])]
    _emit({"phase": 9, "mesh": f"{slots} slots on cuda:0", "count": "phase 3's file", "k": k,
           "distinct": got.distinct, "equal_to_native": True,
           "shards_equal_owner_cut": True, "seconds": sec,
           "peak_device_bytes": torch.cuda.max_memory_allocated(), "launches": launches,
           "shard_sizes": sizes, "gpu": gpu})


# --- phase 10: the public surface -------------------------------------------------


#: a child process that runs the port's CLI entry point (``kmix-torch``,
#: ``krust_tpu_torch.cli:main``) or a streaming API call, as the spec file in
#: argv[1] lists them, and writes each run's exit code, seconds, count span,
#: seconds per span name, table lifetimes (``pull_table`` spans: one a
#: ``finalize``), part merges' entries, kernel launches and device peak to
#: argv[2]. A CLI run reads the
#: child's stdin and writes stdout and stderr to files.
_CHILD = r"""
import io, json, sys, time
import numpy as np
import torch
from krust_tpu_torch import api, cli
from krust_tpu_torch.ops.codec import encode_dense
from krust_tpu_torch.ops.fused_codec import encode_windows
from krust_tpu_torch.ops.merge import merge_sorted, merge_sorted_keys
from krust_tpu_torch.ops.rle import rle_compact
from krust_tpu_torch.utils import tracing

fns = {"encode_windows": encode_windows, "rle_compact": rle_compact,
       "merge_sorted": merge_sorted, "encode_dense": encode_dense,
       "merge_sorted_keys": merge_sorted_keys}
spans = {}
tracing.add_collector(
    lambda kind, name, f: spans.setdefault(name, []).append(f) if kind == "span" else None)
results = []
for run in json.load(open(sys.argv[1])):
    for fn in fns.values():
        fn.launches = 0
    spans.clear()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    if run["kind"] == "cli":
        out, err = open(run["stdout"], "wb"), open(run["stderr"], "wb")
        saved = sys.stdout, sys.stderr
        sys.stdout = io.TextIOWrapper(out, write_through=True)
        sys.stderr = io.TextIOWrapper(err, write_through=True)
        try:
            rc = cli.main(run["argv"])
        except SystemExit as e:
            rc = e.code
        finally:
            seconds = time.perf_counter() - t0
            sys.stdout.flush()
            sys.stderr.flush()
            sys.stdout, sys.stderr = saved
            out.close()
            err.close()
    else:  # the streaming API: the dict it returns, saved as arrays
        got = api.count_kmers_streaming_packed(run["path"], run["k"])
        seconds = time.perf_counter() - t0
        size = len(got)
        np.save(run["codes"], np.fromiter(got.keys(), np.uint64, count=size))
        np.save(run["counts"], np.fromiter(got.values(), np.uint64, count=size))
        rc = 0
    results.append({"rc": rc, "seconds": seconds,
                    "count_s": sum(f["elapsed_s"] for f in spans.get("read_sequences", [])),
                    "span_s": {n: sum(f["elapsed_s"] for f in fs) for n, fs in spans.items()},
                    "lifetimes": len(spans.get("pull_table", [])),
                    "part_merge_entries": [f["entries"] for f in spans.get("part_merge", [])],
                    "launches": {n: fn.launches for n, fn in fns.items()},
                    "peak_device_bytes": torch.cuda.max_memory_allocated()})
json.dump(results, open(sys.argv[2], "w"))
"""


def _child(tmp, runs, engine, stdin=None) -> tuple[list, dict]:
    """Run ``runs`` in one child process with KRUST_ENGINE=``engine``;
    returns each run's result and the child's wall seconds and peak RSS
    (``os.wait4``)."""
    spec, res = os.path.join(tmp, "child_spec.json"), os.path.join(tmp, "child_res.json")
    with open(spec, "w") as f:
        json.dump(runs, f)
    env = dict(os.environ, KRUST_ENGINE=engine)
    t0 = time.perf_counter()
    with open(stdin or os.devnull, "rb") as child_in:
        proc = subprocess.Popen([sys.executable, "-c", _CHILD, spec, res], stdin=child_in,
                                env=env, cwd=os.path.dirname(os.path.abspath(__file__)))
        _, status, usage = os.wait4(proc.pid, 0)
    proc.returncode = os.waitstatus_to_exitcode(status)
    if proc.returncode != 0:
        raise AssertionError(f"phase 10 child ({engine}) exited {proc.returncode}")
    with open(res) as f:
        results = json.load(f)
    return results, {"seconds": time.perf_counter() - t0,
                     "peak_rss_bytes": usage.ru_maxrss * 1024}


def _cli_runs(tmp, tag, argvs) -> list:
    return [{"kind": "cli", "argv": argv,
             "stdout": os.path.join(tmp, f"{tag}_{i}.out"),
             "stderr": os.path.join(tmp, f"{tag}_{i}.err")} for i, argv in enumerate(argvs)]


def _read(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _same_cli_output(dev_runs, nat_runs, dev_res, nat_res, what):
    """Equal exit codes and bytes, run for run; the native side launched
    nothing."""
    for d, n, dr, nr in zip(dev_runs, nat_runs, dev_res, nat_res):
        if dr["rc"] != nr["rc"] or _read(d["stdout"]) != _read(n["stdout"]):
            raise AssertionError(f"{what}: {d['argv']}: device CLI != native CLI")
        if _read(d["stderr"]) != _read(n["stderr"]):
            raise AssertionError(f"{what}: {d['argv']}: stderr differs")
        if any(nr["launches"].values()):
            raise AssertionError(f"{what}: the native CLI launched {nr['launches']}")


def _sum_launches(results) -> dict:
    total: dict = {}
    for r in results:
        for name, n in r["launches"].items():
            total[name] = total.get(name, 0) + n
    return total


def write_genome(path, rng, total_bases, line=60):
    """A genome-shaped FASTA: 24 chromosome records (chr1-22, X, Y) in the
    proportions of the human assembly GRCh38, scaled to ``total_bases``;
    random bases, about half of them soft-masked (lower case) in runs of
    300-6000 bases, and runs of N of 10-200 kbases making about 1% of
    every chromosome; ``line`` bases a line. Returns the record lengths."""
    grch38_mb = [248, 242, 198, 190, 181, 171, 159, 145, 138, 134, 135, 133, 114, 107,
                 102, 90, 83, 80, 59, 64, 47, 51, 156, 57]
    names = [f"chr{i}" for i in range(1, 23)] + ["chrX", "chrY"]
    scale = total_bases / sum(grch38_mb)
    lengths = [int(mb * scale) // line * line for mb in grch38_mb]
    with open(path, "wb") as f:
        for name, n in zip(names, lengths):
            seq = _ACGT[rng.integers(0, 4, size=n, dtype=np.uint8)]
            runs = rng.integers(300, 6001, size=n // 1500 + 2)
            masked = np.repeat(np.arange(runs.shape[0]) % 2 == 1, runs)[:n]
            seq |= masked.astype(np.uint8) << 5  # ASCII upper -> lower case
            n_target, at = n // 100, 0
            while at < n_target:
                run = min(int(rng.integers(10_000, 200_001)), n_target + 1)
                start = int(rng.integers(0, n - run))
                seq[start : start + run] = ord("N")
                at += run
            lines = np.empty((n // line, line + 1), np.uint8)
            lines[:, :line] = seq.reshape(-1, line)
            lines[:, line] = ord("\n")
            f.write(b">" + name.encode() + b"\n")
            f.write(lines.tobytes())
    return lengths


def _phase10(rng, gpu, tmp, main, main4) -> None:
    """BASELINE's five configurations and the streaming path: C1-C5 and S."""
    import gzip
    import shutil

    import torch
    import torch.distributed as dist

    from krust_tpu_torch import api
    from krust_tpu_torch.index import KmerIndex, load_index, serialize_index
    from krust_tpu_torch.kmer import unpack_many
    from krust_tpu_torch.output import OutputFormat, format_packed_counts
    from krust_tpu_torch.parallel.mesh import init_distributed

    torch.cuda.empty_cache()  # the children need the card this process has cached
    repo = os.path.dirname(os.path.abspath(__file__))
    fixtures = os.path.join(repo, "tests", "fixtures")

    # C1: the six fixtures x k x the four formats at --min-count 2
    argvs = []
    for name in sorted(os.listdir(fixtures)):
        for k in (1, 5, 21, 32):
            for fmt in ("fasta", "tsv", "json", "histogram"):
                argv = [str(k), os.path.join(fixtures, name), "-f", fmt, "-m", "2"]
                argvs.append(argv + (["-Q", "20"] if name.endswith(".fq") else []))
    dev_runs, nat_runs = _cli_runs(tmp, "c1d", argvs), _cli_runs(tmp, "c1n", argvs)
    dev_res, dev_proc = _child(tmp, dev_runs, "device")
    nat_res, _ = _child(tmp, nat_runs, "native")
    _same_cli_output(dev_runs, nat_runs, dev_res, nat_res, "C1")
    launches = _sum_launches(dev_res)
    if launches["encode_windows"] <= 0 or launches["rle_compact"] <= 0:
        raise AssertionError(f"C1 skipped a kernel: {launches}")
    _emit({"phase": 10, "case": "C1", "runs": len(argvs), "k": [1, 5, 21, 32],
           "formats": ["fasta", "tsv", "json", "histogram"], "min_count": 2,
           "seconds": sum(r["seconds"] for r in dev_res), "child_s": dev_proc["seconds"],
           "peak_device_bytes": max(r["peak_device_bytes"] for r in dev_res),
           "launches": launches, "equal": True, "gpu": gpu})

    # C2: dirty FASTQ at -Q 20, k = 21, TSV to a file: the dense path
    bases = C2_BASES
    path = os.path.join(tmp, "c2.fq")
    write_reads(path, rng, bases, bases // 32, fastq=True, n_rate=0.02, lowq_rate=0.03)
    argv = ["21", path, "-Q", "20", "-f", "tsv", "-q"]
    dev_runs, nat_runs = _cli_runs(tmp, "c2d", [argv]), _cli_runs(tmp, "c2n", [argv])
    dev_res, dev_proc = _child(tmp, dev_runs, "device")
    nat_res, nat_proc = _child(tmp, nat_runs, "native")
    _same_cli_output(dev_runs, nat_runs, dev_res, nat_res, "C2")
    run = dev_res[0]
    if run["launches"]["encode_dense"] <= 0 or run["launches"]["encode_windows"] != 0:
        raise AssertionError(f"C2 did not take the dense path: {run['launches']}")
    _emit({"phase": 10, "case": "C2", "bases": bases, "k": 21, "min_quality": 20,
           "output_bytes": os.path.getsize(dev_runs[0]["stdout"]), "seconds": run["seconds"],
           "mbases_per_s": bases / 1e6 / run["seconds"], "child_s": dev_proc["seconds"],
           "native_child_s": nat_proc["seconds"],
           "peak_device_bytes": run["peak_device_bytes"], "launches": run["launches"],
           "equal": True, "gpu": gpu})
    for r in dev_runs + nat_runs:
        os.unlink(r["stdout"])
    os.unlink(path)

    # C3: a genome-shaped FASTA through stdin (the chunked path), k = 31,
    # histogram; the native side reads the file. Cut to what the host's
    # memory holds, never below a table lifetime
    mem_total = _mem_total()
    c3_bases = max(C3_MIN_BASES, min(C3_BASES, int(
        mem_total / C3_HOST_SPARE / C3_HOST_BYTES_PER_BASE)))
    path = os.path.join(tmp, "genome.fa")
    t0 = time.perf_counter()
    lengths = write_genome(path, rng, c3_bases)
    gen_s = time.perf_counter() - t0
    dev_runs = _cli_runs(tmp, "c3d", [["31", "-f", "histogram", "-q"]])
    dev_res, dev_proc = _child(tmp, dev_runs, "device", stdin=path)
    nat_runs = _cli_runs(tmp, "c3n", [["31", path, "-f", "histogram", "-q"]])
    nat_res, nat_proc = _child(tmp, nat_runs, "native")
    _same_cli_output(dev_runs, nat_runs, dev_res, nat_res, "C3")
    run = dev_res[0]
    missing = [n for n in ("encode_windows", "rle_compact", "merge_sorted")
               if run["launches"][n] <= 0]
    if missing:
        raise AssertionError(f"C3 never launched {missing}: {run['launches']}")
    if run["lifetimes"] < 2:
        raise AssertionError(f"C3 ran {run['lifetimes']} table lifetime(s), not 2 or more")
    budget = _device_budget(torch.device("cuda", 0))
    if run["peak_device_bytes"] > budget:
        raise AssertionError(f"C3 device peak {run['peak_device_bytes']} > budget {budget:.0f}")
    hist = _read(dev_runs[0]["stdout"]).split()
    distinct = sum(int(f) for f in hist[1::2])
    _emit({"phase": 10, "case": "C3", "bases": sum(lengths), "records": len(lengths),
           "file_bytes": os.path.getsize(path), "k": 31, "stdin": True,
           "chunk_bytes": api.DEFAULT_STDIN_CHUNK_BYTES, "distinct": distinct,
           "host_mem_total_bytes": mem_total, "lifetimes": run["lifetimes"],
           "largest_part_merge_entries": max(run["part_merge_entries"]),
           "part_merge_entries": run["part_merge_entries"],
           "data_gen_s": gen_s, "seconds": run["seconds"], "count_s": run["count_s"],
           "span_s": run["span_s"], "mbases_per_s": sum(lengths) / 1e6 / run["seconds"],
           "child_s": dev_proc["seconds"], "peak_rss_bytes": dev_proc["peak_rss_bytes"],
           "peak_device_bytes": run["peak_device_bytes"], "device_budget_bytes": budget,
           "launches": run["launches"], "native_child_s": nat_proc["seconds"],
           "native_peak_rss_bytes": nat_proc["peak_rss_bytes"], "equal": True, "gpu": gpu})
    os.unlink(path)

    # C4: phase 3's reads, --save .kmix, then query by the CLI and by
    # load_index(...).get
    path, exp = _main_file(rng, tmp, main)
    kmix = os.path.join(tmp, "reads.kmix")
    dev_runs = _cli_runs(tmp, "c4d", [["21", path, "--save", kmix, "-f", "histogram"]])
    dev_res, dev_proc = _child(tmp, dev_runs, "device")
    run = dev_res[0]
    want = format_packed_counts(exp.codes, exp.counts, 21, OutputFormat.HISTOGRAM, 1)
    if run["rc"] != 0 or _read(dev_runs[0]["stdout"]) != want:
        raise AssertionError("C4: device CLI histogram != native core")
    if run["launches"]["encode_windows"] <= 0 or run["launches"]["rle_compact"] <= 0:
        raise AssertionError(f"C4 skipped a kernel: {run['launches']}")
    if _read(kmix) != serialize_index(KmerIndex.from_arrays(21, exp.codes, exp.counts)):
        raise AssertionError("C4: .kmix from the device table != from the native core's")
    pick = rng.choice(exp.distinct, 10, replace=False)
    comp = str.maketrans("ACGT", "TGCA")
    queries = []
    for i, kmer in enumerate(unpack_many(exp.codes[pick], 21)):
        queries.append(kmer.lower() if i % 2 else kmer.translate(comp)[::-1])
    query_runs = _cli_runs(tmp, "c4q", [["query", kmix, q] for q in queries])
    query_res, query_proc = _child(tmp, query_runs, "device")
    for r, res, c in zip(query_runs, query_res, exp.counts[pick]):
        if res["rc"] != 0 or int(_read(r["stdout"])) != int(c):
            raise AssertionError(f"C4: query {r['argv']} != {c}")
    t0 = time.perf_counter()
    index = load_index(kmix)
    load_s = time.perf_counter() - t0
    probes = np.concatenate([exp.codes[rng.integers(0, exp.distinct, 90_000)],
                             rng.integers(0, 1 << 42, 10_000, dtype=np.uint64)])
    t0 = time.perf_counter()
    got = [index.get(int(c)) or 0 for c in probes]
    get_s = time.perf_counter() - t0
    if got != [exp.get(int(c)) for c in probes]:
        raise AssertionError("C4: load_index(...).get != native core")
    _emit({"phase": 10, "case": "C4", "bases": MAIN_BASES, "k": 21,
           "entries": len(index), "kmix_bytes": os.path.getsize(kmix),
           "seconds": run["seconds"], "mbases_per_s": MAIN_BASES / 1e6 / run["seconds"],
           "child_s": dev_proc["seconds"], "peak_device_bytes": run["peak_device_bytes"],
           "launches": run["launches"], "cli_queries": len(queries),
           "query_child_s": query_proc["seconds"], "get_queries": int(probes.shape[0]),
           "load_index_s": load_s, "get_s": get_s, "equal": True, "gpu": gpu})
    del index
    os.unlink(kmix)

    # C5: gzip FASTQ through the streaming API, then sharded in a
    # one-rank NCCL group
    bases = C5_BASES
    plain, gz = os.path.join(tmp, "c5.fq"), os.path.join(tmp, "c5.fq.gz")
    write_reads(plain, rng, bases, GENOME, fastq=True)
    with open(plain, "rb") as f_in, gzip.open(gz, "wb", compresslevel=1) as f_out:
        shutil.copyfileobj(f_in, f_out, 64 << 20)
    os.unlink(plain)
    exp5 = _native_counts(gz, 21)
    rows = []
    for entry in ("streaming_packed", "sharded_nccl"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _zero_launches()
        t0 = time.perf_counter()
        if entry == "streaming_packed":
            got = api.count_kmers_streaming_packed(gz, 21)
            sec = time.perf_counter() - t0
            n = len(got)
            equal = (np.array_equal(np.fromiter(got.keys(), np.uint64, count=n), exp5.codes)
                     and np.array_equal(np.fromiter(got.values(), np.uint64, count=n),
                                        exp5.counts))
        else:
            init_distributed(f"file://{os.path.join(tmp, 'pg10')}", rank=0, world_size=1)
            try:
                t0 = time.perf_counter()
                got = api.count_kmers_sharded_result(gz, 21)
                sec = time.perf_counter() - t0
            finally:
                dist.destroy_process_group()
            equal = (np.array_equal(got.codes, exp5.codes)
                     and np.array_equal(got.counts, exp5.counts))
        launches = _launches()
        if not equal:
            raise AssertionError(f"C5 {entry}: port != native core")
        if launches["encode_windows"] <= 0 or launches["rle_compact"] <= 0:
            raise AssertionError(f"C5 {entry} skipped a kernel: {launches}")
        rows.append({"entry": entry, "seconds": sec, "mbases_per_s": bases / 1e6 / sec,
                     "peak_device_bytes": torch.cuda.max_memory_allocated(),
                     "launches": launches})
        del got
    _emit({"phase": 10, "case": "C5", "bases": bases, "gzip_bytes": os.path.getsize(gz),
           "k": 21, "distinct": exp5.distinct, "runs": rows, "equal": True, "gpu": gpu})
    os.unlink(gz)

    # S: phase 4's 1.25-epoch file through count_kmers_streaming_packed in
    # 256 MiB chunks, in a child (its own peak RSS)
    path, exp = main4 if main4 is not None else _main4_file(rng, tmp)
    runs = [{"kind": "streaming_packed", "path": path, "k": 21,
             "codes": os.path.join(tmp, "s_codes.npy"),
             "counts": os.path.join(tmp, "s_counts.npy")}]
    res, proc = _child(tmp, runs, "device")
    run = res[0]
    codes, counts = np.load(runs[0]["codes"]), np.load(runs[0]["counts"])
    if not (np.array_equal(codes, exp.codes) and np.array_equal(counts, exp.counts)):
        raise AssertionError("S: count_kmers_streaming_packed != native core")
    missing = [n for n in ("encode_windows", "rle_compact", "merge_sorted")
               if run["launches"][n] <= 0]
    if missing:
        raise AssertionError(f"S never launched {missing}: {run['launches']}")
    file_bytes = os.path.getsize(path)
    bases = file_bytes // (READ_LEN + 4) * READ_LEN
    _emit({"phase": 10, "case": "S", "bases": bases, "file_bytes": file_bytes, "k": 21,
           "chunk_bytes": api.DEFAULT_STREAMING_CHUNK_BYTES,
           "chunks": -(-file_bytes // api.DEFAULT_STREAMING_CHUNK_BYTES),
           "distinct": int(codes.shape[0]), "seconds": run["seconds"],
           "count_s": run["count_s"], "mbases_per_s": bases / 1e6 / run["seconds"],
           "child_s": proc["seconds"],
           "peak_rss_bytes": proc["peak_rss_bytes"],
           "peak_device_bytes": run["peak_device_bytes"], "launches": run["launches"],
           "equal": True, "gpu": gpu})
    for r in runs:
        os.unlink(r["codes"])
        os.unlink(r["counts"])


def _phase11(gpu, tmp) -> dict:
    """krust_tpu's behaviour suites, loaded against the port, on the card:
    returns the kernels' launches over the run."""
    import glob

    import torch

    torch.cuda.empty_cache()  # the child needs the card this process has cached
    repo = os.path.dirname(os.path.abspath(__file__))
    files = sorted(os.path.relpath(p, repo)
                   for p in glob.glob(os.path.join(repo, "tests", "test_torch_ref_*.py")))
    files = [f for f in files if f not in PHASE11_LEFT_OUT]
    res, log = os.path.join(tmp, "phase11.json"), os.path.join(tmp, "phase11.log")
    env = {k: v for k, v in os.environ.items() if k not in ("KRUST_PLATFORM", "KRUST_ENGINE")}
    argv = [sys.executable, os.path.join("tests", "torch_reference_suite.py"), res, *files,
            "-q", "-rfE", "-m", "not slow", "-p", "no:randomly",
            f"--basetemp={os.path.join(tmp, 'phase11')}"]
    with open(log, "w") as out:
        rc = subprocess.run(argv, cwd=repo, env=env, stdout=out, stderr=subprocess.STDOUT,
                            timeout=600).returncode
    with open(log) as f:
        tail = f.read()[-6000:]
    if rc != 0 or not os.path.exists(res):
        raise AssertionError(f"phase 11 child exited {rc}:\n{tail}")
    with open(res) as f:
        r = json.load(f)
    formed = {f"tests/test_torch_ref_{name[len('test_'):]}.py" for name in PHASE11_FORMED}
    _emit({"phase": 11, "files": len(files), "left_out": list(PHASE11_LEFT_OUT),
           "rc": r["rc"], "passed": r["passed"],
           "failed": r["failed"], "errors": r["error"], "xfailed": r["xfailed"],
           "xpassed": r["xpassed"], "skipped": r["skipped"], "deselected": r["deselected"],
           "seconds": r["seconds"], "launches": r["launches"],
           "formed": {f: {key: o[key] for key in ("passed", "xfailed", "failed", "error",
                                                   "xpassed", "seconds")}
                      for f, o in sorted(r["files"].items()) if f in formed},
           "gpu": gpu})
    if r["rc"] != 0 or r["failed"] or r["error"] or r["xpassed"] or not r["passed"]:
        raise AssertionError(f"phase 11: the loaded suites failed:\n{tail}")
    if formed - set(r["files"]):
        raise AssertionError(f"phase 11 ran no test of {sorted(formed - set(r['files']))}")
    missing = [name for name in ("encode_windows", "rle_compact", "merge_sorted",
                                 "merge_sorted_keys") if not r["launches"][name]]
    if missing:
        raise AssertionError(f"phase 11 never launched {missing}: {r['launches']}")
    return r["launches"]


#: per kernel wrapper: its source, the TPU kernel it replaces, the phase
#: whose counting run (or, for K5, timing) gives its launches, and the
#: design it was rebuilt to for the card
_REPLACES = {
    "encode_windows": ("krust_tpu_torch/csrc/fused_codec.cu",
                       "krust_tpu/ops/pallas_fused.py:258", 4, "tiled codec"),
    "rle_compact": ("krust_tpu_torch/csrc/rle.cu", "krust_tpu/ops/pallas_rle.py:366", 4,
                    "single-pass reduce-by-key"),
    "merge_sorted": ("krust_tpu_torch/csrc/merge.cu",
                     "krust_tpu/ops/pallas_merge.py:522 (merge_sorted_kv) and "
                     ":414 (merge_sorted_lv)", 4, "merge-path tiled merge"),
    "encode_dense": ("krust_tpu_torch/csrc/codec.cu",
                     "krust_tpu/ops/pallas_codec.py:145", 7, "tiled row codec"),
    "merge_sorted_keys": ("krust_tpu_torch/csrc/merge.cu",
                          "krust_tpu/ops/pallas_merge.py:248", 2, "merge-path tiled merge"),
    "count_histogram": ("krust_tpu_torch/csrc/histogram.cu",
                        "none (krust_tpu takes the histogram on the host, np.unique)", 4,
                        "new: shared-memory bins, warp-aggregated"),
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phases", default=",".join(map(str, sorted(ALL_PHASES))))
    args = ap.parse_args()
    phases = {int(p) for p in args.phases.split(",")}

    if not os.path.isdir(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                      "krust_tpu_torch")):
        print("chip_smoke: no krust_tpu_torch package beside this script", file=sys.stderr)
        return 2

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    os.environ["KRUST_ENGINE"] = "device"
    from krust_tpu_torch.ops import _cuda

    dev = torch.device("cuda", 0)
    gpu = _gpu_line()
    t0 = time.perf_counter()
    _cuda.library()
    build_s = time.perf_counter() - t0
    nvcc = subprocess.run([_cuda.nvcc_path(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-1]
    _emit({"phase": 1, "gpu": gpu, "torch": torch.__version__,
           "cuda": torch.version.cuda, "nvcc": nvcc, "python": sys.version.split()[0],
           "kernel_build_s": build_s, "nvcc_build_s": _cuda.build_seconds,
           "host_mem_total_bytes": _mem_total(),
           "device_total_bytes": torch.cuda.mem_get_info(dev)[1]})
    _emit({"phase": 1, "ptxas": _cuda.ptxas_report()})

    rng = np.random.default_rng(args.seed)
    g = torch.Generator(device=dev)
    g.manual_seed(args.seed)
    results: dict = {}
    if 2 in phases:
        _check_codec(rng, gpu, dev, results)
        _check_rle(g, gpu, dev, results)
        _check_merge(g, gpu, dev, results)
        _check_dense(rng, gpu, dev, results)
        _check_encode_blocks(rng, gpu, dev, results)
        _check_merge_keys(rng, gpu, dev, results)
        _check_histogram(g, gpu, dev, results)
        torch.cuda.empty_cache()
        merge_runs_points = _check_merge_runs(g, gpu, dev)
        _check_large_index(gpu, dev)
        _derive_limits(gpu, dev, _memory_fits(g, gpu, dev, merge_runs_points))
        torch.cuda.empty_cache()

    launches = {2: {"merge_sorted_keys": results.get("merge_sorted_keys", {}).get("launches")}}
    with tempfile.TemporaryDirectory() as tmp:
        main = main4 = None
        if 3 in phases:
            main = _phase3(rng, gpu, tmp, keep=bool({8, 9, 10} & phases))
        if 4 in phases:
            launches[4], main4 = _phase4(rng, gpu, tmp, keep=bool({9, 10} & phases))
        if 5 in phases:
            _phase5(rng, gpu, tmp)
        if 6 in phases:
            _phase6(rng, gpu, tmp)
        if 7 in phases:
            launches[7] = _phase7(rng, gpu, tmp)
        if 8 in phases:
            main = _phase8(rng, gpu, tmp, main)
        if 9 in phases:
            main4, launches[9], launches["9 group"] = _phase9(rng, gpu, tmp, main, main4)
        if 10 in phases:
            _phase10(rng, gpu, tmp, main, main4)
        if 11 in phases:
            launches[11] = _phase11(gpu, tmp)

    kernels = []
    by_blocks = results.get("encode_blocks_launches", {})
    for name, (source, replaces, phase, redesigned) in _REPLACES.items():
        r = results.get(name, {})
        n = [v for v in (launches.get(phase, {}).get(name), by_blocks.get(name)) if v is not None]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "redesigned": redesigned,
                        "launches": sum(n) if n else None,
                        "launches_phase": phase,
                        "launches_encode_blocks": by_blocks.get(name),
                        "launches_local_mesh": launches.get(9, {}).get(name),
                        "launches_group_slots": launches.get("9 group", {}).get(name),
                        "launches_reference_suites": launches.get(11, {}).get(name),
                        "max_abs_err": r.get("max_abs_err"),
                        "ms": r.get("ms"), "plain_ms": r.get("plain_ms"),
                        "bound_ms": r.get("bound_ms"), "bound_by": r.get("bound_by"),
                        "library_ms": r.get("library_ms")})
    print(gpu, flush=True)
    _emit({"kernels": kernels})
    if phases != ALL_PHASES:
        return 0  # a partial run proves less: no result line
    _emit({"ok": True, "device": {"platform": "gpu",
                                  "kind": torch.cuda.get_device_name(0),
                                  "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
