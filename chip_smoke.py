"""Smoke test of krust_tpu_torch on one NVIDIA GPU: kernels, then the counting paths.

    python3 chip_smoke.py [--seed N] [--phases 1,2,3,4,5,6,7]

Needs a CUDA device and ``nvcc`` (the kernels build from
``krust_tpu_torch/csrc`` at first use, one nvcc per source, in parallel).
Phases, printing JSON lines:

1. environment: GPU name and power limit, torch / CUDA / nvcc versions,
   kernel build time, and each kernel's registers, shared memory and
   spills as ptxas reported them;
2. each CUDA kernel against its plain PyTorch version on the card, at the
   main path's shapes, exactly equal (integer work: tolerance 0), with
   kernel and plain times, the least time the card could take for the same
   work (``bound_ms``) and, where one PyTorch call computes the same
   function, that call's time (``library_ms``; never called by the port).
   K1 also runs with no invalid position, and K2 on one run over every
   tile. K3 runs on two random parts of 2^24 entries and on two parts
   shaped like phase 4's merge (2^26 entries each, about 46M distinct keys
   that both parts share, sentinel tails), in both key widths; the kernel
   line takes the int64 shared row. K5 lies on no counting path: its
   launches in the kernel line are those of its timing here;
3. bench.py's workload: 512 Mbases of 250 bp reads at 32x over a 16 Mbase
   genome (made with numpy from --seed), written as FASTA and counted at
   k = 21 through ``api.count_with_input`` with KRUST_ENGINE=device, twice,
   timed; the full table must equal the native C++ core's. It fits one
   epoch of the default size, so it launches no merge;
4. the clean main path at the default, memory-scaled epoch size: 1.25
   epochs of reads at 32x (about 1.5 Gbases on an 80 GB card), k = 21, so
   the table sorts two epochs and merges their parts. The launch counters
   are set to 0 just before this count and read just after it; K1-K3 must
   have launched. Peak device memory is recorded. Equal to the native core;
5. multi-epoch: 64 Mbases with KRUST_EPOCH_ENTRIES = 2^22 at k = 16 and 31
   (both key widths of the merge kernel), equal to the native core;
6. edge k and masks on the flat path: FASTQ with Ns, soft-masking and
   -Q 20 at k in {1, 5, 17, 24, 32}, ~8 Mbases each, equal to the native
   core; plus one CLI run (``python -m krust_tpu_torch``) against it;
7. the dense path at full size: 512 Mbases of 250 bp FASTQ reads at 32x
   over a 16 Mbase genome with about 5% of bases N or below Q20 (above the
   1/32 line), counted at -Q 20, k = 21, twice, timed, with the counters
   set to 0 just before each count (K4 and K2 must launch, K1 must not),
   equal to the native core; the host time of ``pack_buffer_2bit``; the
   same parsed stream timed on both device routes (dense, and flat with
   the invalid positions scanned without the 1/32 limit); a dirty ~8 Mbase
   FASTQ at k in {1, 5, 16, 17, 24, 32} and one block_windows = 8 count.

The second-to-last line is the kernel table (launches from each kernel's
phase, times from phase 2), the last line the result. Any failed check
raises: the script exits non-zero and prints no result.
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
ALL_PHASES = {1, 2, 3, 4, 5, 6, 7}

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
    """Integer operations of a codec kernel: per group of four windows,
    k + 3 base extractions with their forward and reverse-complement
    updates (about 8 operations each), and 4 per window for the canonical
    minimum, the validity test and the store."""
    return n_windows / 4 * (8 * (k + 3) + 16)


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


def _shared_parts(g, dtype, dev):
    """Two compacted parts shaped like phase 4's merge: 2^26 entries each
    (round_pow2 of about 46M distinct keys), part a the whole sorted pool,
    part b about 99.7% of it (two epochs over one genome), counts 1-500,
    sentinel tails with count 0."""
    import torch

    m = 1 << 26
    lo = torch.iinfo(dtype).min
    span = 2**32 - 1 if dtype == torch.int32 else 2**42
    pool = torch.unique(torch.randint(lo, lo + span, (46_000_000,), generator=g, device=dev,
                                      dtype=dtype))
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
    results["encode_dense"] = dict(
        times[21], max_abs_err=max(t["max_abs_err"] for t in times.values())
    )


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


# --- phases 3-5: the main path ---------------------------------------------------


_ACGT = np.frombuffer(b"ACGT", np.uint8)


def write_reads(path, rng, n_bases, genome_len, fastq=False, n_rate=0.0,
                 soft_rate=0.0, lowq_rate=0.0):
    """Reads of READ_LEN bases at random positions of a random genome."""
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
    from krust_tpu_torch.ops.merge import merge_sorted, merge_sorted_keys
    from krust_tpu_torch.ops.rle import rle_compact

    return {"encode_windows": encode_windows, "rle_compact": rle_compact,
            "merge_sorted": merge_sorted, "encode_dense": encode_dense,
            "merge_sorted_keys": merge_sorted_keys}


def _launches() -> dict:
    return {name: fn.launches for name, fn in _counters().items()}


def _zero_launches() -> None:
    for fn in _counters().values():
        fn.launches = 0


def _phase3(rng, gpu, tmp):
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
    runs = []
    got = None
    for _ in range(2):
        before = _launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        got = _port_counts(path, 21)
        sec = time.perf_counter() - t0
        after = _launches()
        runs.append({"seconds": sec, "mbases_per_s": MAIN_BASES / 1e6 / sec,
                     "peak_device_bytes": torch.cuda.max_memory_allocated(),
                     "launches": {n: after[n] - before[n] for n in after}})
    for r in runs:
        if r["launches"]["encode_windows"] <= 0 or r["launches"]["rle_compact"] <= 0:
            raise AssertionError(f"phase 3 skipped a kernel: {r['launches']}")
    t0 = time.perf_counter()
    exp = _native_counts(path, 21)
    native_s = time.perf_counter() - t0
    _assert_equal(got, exp, "phase 3 k=21")
    _emit({"phase": 3, "k": 21, "bases": MAIN_BASES, "read_len": READ_LEN,
           "genome": GENOME, "distinct": got.distinct, "total": got.total,
           "equal_to_native": True, "data_gen_s": gen_s, "runs": runs,
           "native_core_s": native_s, "gpu": gpu})
    os.unlink(path)


def _phase4(rng, gpu, tmp) -> dict:
    """The clean main path at the default epoch size; returns its launch
    counts."""
    import torch

    from krust_tpu_torch.ops.table import epoch_entry_limit

    dev = torch.device("cuda", 0)
    limit = epoch_entry_limit(dev)
    bases = limit * 5 // 4 // READ_LEN * READ_LEN
    genome = bases // 32
    path = os.path.join(tmp, "reads_main.fa")
    write_reads(path, rng, bases, genome)
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
    t0 = time.perf_counter()
    exp = _native_counts(path, 21)
    native_s = time.perf_counter() - t0
    _assert_equal(got, exp, "phase 4 k=21")
    _emit({"phase": 4, "k": 21, "bases": bases, "read_len": READ_LEN, "genome": genome,
           "epoch_entries": limit, "distinct": got.distinct, "total": got.total,
           "equal_to_native": True, "seconds": sec, "mbases_per_s": bases / 1e6 / sec,
           "peak_device_bytes": peak,
           "device_total_bytes": torch.cuda.mem_get_info(dev)[1],
           "launches": launches, "native_core_s": native_s, "gpu": gpu})
    os.unlink(path)
    return launches


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

    runs, first = [], None
    for _ in range(2):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _zero_launches()
        t0 = time.perf_counter()
        got = _port_counts(path, k, min_quality=q)
        sec = time.perf_counter() - t0
        launches = _launches()
        dense_only(launches, "phase 7")
        _assert_equal(got, exp, "phase 7 k=21")
        first = first or launches
        runs.append({"seconds": sec, "mbases_per_s": MAIN_BASES / 1e6 / sec,
                     "peak_device_bytes": torch.cuda.max_memory_allocated(),
                     "launches": launches})

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
    flat_batches = packer.flat_batches

    def flat_route(codes, qual, kk, t, w, rows):
        """The flat layout without its 1/32 limit (a measurement only)."""
        scanned = packer.flat_scan(codes, qual, t, codes.shape[0])
        return flat_batches(codes, qual, kk, t, w, rows, prescanned=scanned)

    route_s = {"dense": [], "flat": []}
    for name in ("dense", "flat", "flat", "dense"):
        _zero_launches()
        if name == "flat":
            packer.flat_batches = flat_route
        try:
            t0 = time.perf_counter()
            got = engine.count(streams, k, q)
            route_s[name].append(time.perf_counter() - t0)
        finally:
            packer.flat_batches = flat_batches
        launches = _launches()
        codec = "encode_dense" if name == "dense" else "encode_windows"
        other = "encode_windows" if name == "dense" else "encode_dense"
        if launches[codec] <= 0 or launches[other] != 0:
            raise AssertionError(f"route {name}: {launches}")
        _assert_equal(got, exp, f"phase 7 route {name}")
    _emit({"phase": 7, "k": k, "min_quality": q, "bases": MAIN_BASES, "read_len": READ_LEN,
           "genome": GENOME, "invalid_share": invalid_share, "distinct": exp.distinct,
           "total": exp.total, "equal_to_native": True, "data_gen_s": gen_s, "runs": runs,
           "native_core_s": native_s, "pack_buffer_2bit_s": pack_s,
           "pack_buffer_2bit_batches": n_batches, "flat_scan_unlimited_s": scan_s,
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


#: per kernel wrapper: its source, the TPU kernel it replaces, the phase
#: whose counting run (or, for K5, timing) gives its launches, and the
#: design it was rebuilt to for the card (None: still its first port)
_REPLACES = {
    "encode_windows": ("krust_tpu_torch/csrc/fused_codec.cu",
                       "krust_tpu/ops/pallas_fused.py:258", 4, "tiled codec"),
    "rle_compact": ("krust_tpu_torch/csrc/rle.cu", "krust_tpu/ops/pallas_rle.py:366", 4,
                    "single-pass reduce-by-key"),
    "merge_sorted": ("krust_tpu_torch/csrc/merge.cu",
                     "krust_tpu/ops/pallas_merge.py:522 (merge_sorted_kv) and "
                     ":414 (merge_sorted_lv)", 4, "merge-path tiled merge"),
    "encode_dense": ("krust_tpu_torch/csrc/codec.cu",
                     "krust_tpu/ops/pallas_codec.py:145", 7, None),
    "merge_sorted_keys": ("krust_tpu_torch/csrc/merge.cu",
                          "krust_tpu/ops/pallas_merge.py:248", 2, "merge-path tiled merge"),
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phases", default=",".join(map(str, sorted(ALL_PHASES))))
    args = ap.parse_args()
    phases = {int(p) for p in args.phases.split(",")}

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
           "kernel_build_s": build_s, "nvcc_build_s": _cuda.build_seconds})
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
        _check_merge_keys(rng, gpu, dev, results)
        torch.cuda.empty_cache()

    launches = {2: {"merge_sorted_keys": results.get("merge_sorted_keys", {}).get("launches")}}
    with tempfile.TemporaryDirectory() as tmp:
        if 3 in phases:
            _phase3(rng, gpu, tmp)
        if 4 in phases:
            launches[4] = _phase4(rng, gpu, tmp)
        if 5 in phases:
            _phase5(rng, gpu, tmp)
        if 6 in phases:
            _phase6(rng, gpu, tmp)
        if 7 in phases:
            launches[7] = _phase7(rng, gpu, tmp)

    kernels = []
    for name, (source, replaces, phase, redesigned) in _REPLACES.items():
        r = results.get(name, {})
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "redesigned": redesigned,
                        "launches": launches.get(phase, {}).get(name),
                        "launches_phase": phase, "max_abs_err": r.get("max_abs_err"),
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
