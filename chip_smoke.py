"""Smoke test of krust_tpu_torch on one NVIDIA GPU: kernels, then the main path.

    python3 chip_smoke.py [--seed N] [--phases 1,2,3,4,5,6]

Needs a CUDA device and ``nvcc`` (the kernels build from
``krust_tpu_torch/csrc`` at first use). Phases, printing JSON lines:

1. environment: GPU name and power limit, torch / CUDA / nvcc versions,
   kernel build time;
2. each CUDA kernel against its plain PyTorch version on the card, at the
   main path's shapes, exactly equal (integer work: tolerance 0), with
   kernel and plain times;
3. bench.py's workload: 512 Mbases of 250 bp reads at 32x over a 16 Mbase
   genome (made with numpy from --seed), written as FASTA and counted at
   k = 21 through ``api.count_with_input`` with KRUST_ENGINE=device, twice,
   timed; the full table must equal the native C++ core's. It fits one
   epoch of the default size, so it launches no merge;
4. the main path at the default, memory-scaled epoch size: 1.25 epochs of
   reads at 32x (about 1.5 Gbases on an 80 GB card), k = 21, so the table
   sorts two epochs and merges their parts. The launch counters are set
   to 0 just before this count and read just after it; every kernel must
   have launched. Peak device memory is recorded. Equal to the native core;
5. multi-epoch: 64 Mbases with KRUST_EPOCH_ENTRIES = 2^22 at k = 16 and 31
   (both key widths of the merge kernel), equal to the native core;
6. edge k and masks: FASTQ with Ns, soft-masking and -Q 20 at
   k in {1, 5, 17, 24, 32}, ~8 Mbases each, and a dirty FASTQ (about 7% of
   bases invalid or below Q20) at k = 21, equal to the native core; plus
   one CLI run (``python -m krust_tpu_torch``) against the native core.

Phases 3, 5 and 6 report their own launches. The second-to-last line is the
kernel table (launches from phase 4, times from phase 2), the last line the
result. Any failed check raises: the script exits non-zero and prints no
result.
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
    for k in (16, 21, 31, 32):
        n_bases = n_windows + k - 1
        codes = rng.integers(0, 4, size=n_bases, dtype=np.uint8)
        codes[rng.random(n_bases) < 0.01] = INVALID_CODE  # dirty stream
        inv = np.flatnonzero(codes >= INVALID_CODE).astype(np.int32)
        packed = np.zeros(n_windows // 4 + TAIL_BYTES, np.uint8)
        p = pack2_full(codes)
        packed[: p.shape[0]] = p
        covered = n_windows - 1000  # a ragged tail of padding windows
        pk = torch.from_numpy(packed).to(dev)
        iv = torch.from_numpy(inv).to(dev)
        got = encode_windows(pk, iv, covered, k, n_windows)
        exp = encode_windows_plain(pk, iv, covered, k, n_windows)
        torch.cuda.synchronize()
        err = _max_abs_err([(got, exp)])
        if not torch.equal(got, exp):
            raise AssertionError(f"K1 k={k}: kernel != plain")
        ms = _time_ms(lambda: encode_windows(pk, iv, covered, k, n_windows))
        plain_ms = _time_ms(lambda: encode_windows_plain(pk, iv, covered, k, n_windows), 2)
        times[k] = (ms, plain_ms, err)
        _emit({"phase": 2, "kernel": "encode_windows", "k": k, "windows": n_windows,
               "equal": True, "ms": ms, "plain_ms": plain_ms, "gpu": gpu})
    ms, plain_ms, err = times[21]  # the main path's k
    results["encode_windows"] = {"max_abs_err": max(t[2] for t in times.values()),
                                 "ms": ms, "plain_ms": plain_ms}


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
    for dtype, weighted in ((torch.int64, False), (torch.int64, True), (torch.int32, False)):
        keys = _sorted_keys(g, n, n // 16, dtype, dev)
        cnt = (
            torch.randint(1, 100, (n,), generator=g, device=dev, dtype=torch.int32)
            if weighted else None
        )
        got = rle_compact(keys, cnt)
        exp = rle_compact_plain(keys, cnt)
        torch.cuda.synchronize()
        err = _max_abs_err(zip(got, exp))
        if err or not all(torch.equal(a, b) for a, b in zip(got, exp)):
            raise AssertionError(f"K2 {dtype} weighted={weighted}: kernel != plain")
        ms = _time_ms(lambda: rle_compact(keys, cnt))
        plain_ms = _time_ms(lambda: rle_compact_plain(keys, cnt), 2)
        _emit({"phase": 2, "kernel": "rle_compact", "keys": str(dtype), "n": n,
               "weighted": weighted, "n_unique": int(got[2].item()), "equal": True,
               "ms": ms, "plain_ms": plain_ms, "gpu": gpu})
        if timed is None:
            timed = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
        del keys, cnt, got, exp
    results["rle_compact"] = timed


def _check_merge(g, gpu, dev, results):
    import torch

    from krust_tpu_torch.ops.merge import merge_sorted, merge_sorted_plain
    from krust_tpu_torch.ops.rle import rle_compact_plain

    m = 1 << 24
    timed = None
    for dtype in (torch.int64, torch.int32):
        parts = []
        for _ in range(2):
            keys = _sorted_keys(g, m, m // 2, dtype, dev)
            ck, cc, _ = rle_compact_plain(keys)  # a compacted part: unique + tail
            parts += [ck, cc]
        got = merge_sorted(*parts)
        exp = merge_sorted_plain(*parts)
        torch.cuda.synchronize()
        err = _max_abs_err(zip(got, exp))
        if err or not all(torch.equal(a, b) for a, b in zip(got, exp)):
            raise AssertionError(f"K3 {dtype}: kernel != plain")
        ms = _time_ms(lambda: merge_sorted(*parts))
        plain_ms = _time_ms(lambda: merge_sorted_plain(*parts), 2)
        _emit({"phase": 2, "kernel": "merge_sorted", "keys": str(dtype),
               "entries": [m, m], "equal": True, "ms": ms, "plain_ms": plain_ms,
               "gpu": gpu})
        if timed is None:
            timed = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
    results["merge_sorted"] = timed


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
    from krust_tpu_torch.ops.fused_codec import encode_windows
    from krust_tpu_torch.ops.merge import merge_sorted
    from krust_tpu_torch.ops.rle import rle_compact

    return {"encode_windows": encode_windows, "rle_compact": rle_compact,
            "merge_sorted": merge_sorted}


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
    """The main path at the default epoch size; returns its launch counts."""
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
    missing = [n for n, c in launches.items() if c <= 0]
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
    # a dirty stream: more than 1/32 of the bases invalid (the JAX package's
    # dense path; the port keeps it on the flat kernel path)
    dirty = os.path.join(tmp, "dirty.fq")
    write_reads(dirty, rng, 8_000_000, 1_000_000, fastq=True, n_rate=0.05,
                 soft_rate=0.05, lowq_rate=0.02)
    got = _port_counts(dirty, 21, min_quality=20)
    _assert_equal(got, _native_counts(dirty, 21, 20), "phase 6 dirty k=21")
    _emit({"phase": 6, "k": 21, "bases": 8_000_000, "min_quality": 20,
           "invalid_share": "~0.07", "distinct": got.distinct, "equal_to_native": True})
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


_REPLACES = {
    "encode_windows": ("krust_tpu_torch/csrc/fused_codec.cu",
                       "krust_tpu/ops/pallas_fused.py:258"),
    "rle_compact": ("krust_tpu_torch/csrc/rle.cu", "krust_tpu/ops/pallas_rle.py:366"),
    "merge_sorted": ("krust_tpu_torch/csrc/merge.cu",
                     "krust_tpu/ops/pallas_merge.py:522 (merge_sorted_kv) and "
                     ":414 (merge_sorted_lv)"),
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phases", default="1,2,3,4,5,6")
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

    rng = np.random.default_rng(args.seed)
    g = torch.Generator(device=dev)
    g.manual_seed(args.seed)
    results: dict = {}
    if 2 in phases:
        _check_codec(rng, gpu, dev, results)
        _check_rle(g, gpu, dev, results)
        _check_merge(g, gpu, dev, results)
        torch.cuda.empty_cache()

    launches = {name: None for name in _REPLACES}
    with tempfile.TemporaryDirectory() as tmp:
        if 3 in phases:
            _phase3(rng, gpu, tmp)
        if 4 in phases:
            launches = _phase4(rng, gpu, tmp)
        if 5 in phases:
            _phase5(rng, gpu, tmp)
        if 6 in phases:
            _phase6(rng, gpu, tmp)

    kernels = []
    for name, (source, replaces) in _REPLACES.items():
        r = results.get(name, {})
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": r.get("max_abs_err"), "ms": r.get("ms"),
                        "plain_ms": r.get("plain_ms")})
    print(gpu, flush=True)
    _emit({"kernels": kernels})
    if phases != {1, 2, 3, 4, 5, 6}:
        return 0  # a partial run proves less: no result line
    _emit({"ok": True, "device": {"platform": "gpu",
                                  "kind": torch.cuda.get_device_name(0),
                                  "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
