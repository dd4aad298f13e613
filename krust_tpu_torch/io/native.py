"""ctypes loaders for the native C++ parser and ingest (graceful numpy fallback).

Builds the package's own ``io/native/krust_native.cpp`` (a byte-for-byte
copy of the JAX package's core, held equal by a test) and, as a library of
its own, ``io/native/ingest.cpp`` (the range-parallel parse of whole
inputs, optionally over a mapping of the file) with g++ on first use, each
cached as a .so under ``krust_tpu_torch/_build/`` keyed by its source's
content hash. Disable both with ``KRUST_NO_NATIVE=1``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from functools import partial

import numpy as np

from ..errors import FormatError

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "native", "krust_native.cpp")
_INGEST_SRC = os.path.join(os.path.dirname(_SRC), "ingest.cpp")
_BUILD = os.path.join(_PKG, "_build")
_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None
_LOAD_FAILED = False
_INGEST: ctypes.CDLL | None = None
_INGEST_FAILED = False

_ERRORS = {
    1: "FASTA input does not start with a '>' header line",
    2: "FASTQ input line count is not a multiple of 4",
    3: "FASTQ record header does not start with '@'",
    4: "FASTQ separator line does not start with '+'",
    5: "FASTQ sequence and quality lengths differ",
}


def _build_lib(src: str = _SRC, stem: str = "libkrust_native_") -> str:
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    os.makedirs(_BUILD, exist_ok=True)
    lib_path = os.path.join(_BUILD, f"{stem}{digest}.so")
    if os.path.exists(lib_path):
        return lib_path
    tmp = lib_path + f".tmp{os.getpid()}"
    subprocess.run(
        [
            "g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
            "-pthread", "-o", tmp, src,
        ],
        check=True,
        capture_output=True,
    )
    os.replace(tmp, lib_path)
    # drop caches of older source revisions and orphaned .tmp<pid> files from
    # crashed builds (safe on Linux: an unlinked .so stays mapped in any
    # process that already loaded it; a process racing between its exists()
    # check and dlopen retries the build — see _get_lib)
    prefix = os.path.join(_BUILD, stem)
    for old in os.listdir(_BUILD):
        full = os.path.join(_BUILD, old)
        stale = full.endswith(".so") and full != lib_path
        orphan = ".so.tmp" in old and full != tmp
        if full.startswith(prefix) and (stale or orphan):
            try:
                os.unlink(full)
            except OSError:
                pass
    return lib_path


def _load(src: str, stem: str) -> ctypes.CDLL | None:
    """Build (or find) and load one library; None when that fails."""
    try:
        try:
            return ctypes.CDLL(_build_lib(src, stem))
        except OSError:
            # a concurrent upgrade may unlink the .so between our
            # exists() check and dlopen; one rebuild settles it
            return ctypes.CDLL(_build_lib(src, stem))
    except Exception:
        return None


def _get_lib() -> ctypes.CDLL | None:
    global _LIB, _LOAD_FAILED
    if _LIB is not None or _LOAD_FAILED:
        return _LIB
    if os.environ.get("KRUST_NO_NATIVE"):
        _LOAD_FAILED = True
        return None
    with _LOCK:
        if _LIB is not None or _LOAD_FAILED:
            return _LIB
        lib = _load(_SRC, "libkrust_native_")
        if lib is None:
            _LOAD_FAILED = True
            return None
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.krust_parse_fasta.restype = ctypes.c_int32
        lib.krust_parse_fasta.argtypes = [u8p, ctypes.c_int64, u8p, i64p, i64p, i64p]
        lib.krust_parse_fastq.restype = ctypes.c_int32
        lib.krust_parse_fastq.argtypes = [
            u8p, ctypes.c_int64, u8p, u8p, i64p, i64p, i64p,
        ]
        if hasattr(lib, "krust_pack2"):
            lib.krust_pack2.restype = None
            lib.krust_pack2.argtypes = [u8p, ctypes.c_int64, u8p]
        if hasattr(lib, "krust_scan_stream"):
            lib.krust_scan_stream.restype = ctypes.c_int64
            lib.krust_scan_stream.argtypes = [
                u8p, ctypes.c_int64, u8p, ctypes.c_int32, u8p, i64p,
                ctypes.c_int64,
            ]
        if hasattr(lib, "krust_populate_write"):
            lib.krust_populate_write.restype = None
            lib.krust_populate_write.argtypes = [u8p, ctypes.c_int64]
        if hasattr(lib, "krust_count_stream"):
            u64p = ctypes.POINTER(ctypes.c_uint64)
            lib.krust_count_stream.restype = ctypes.c_int64
            lib.krust_count_stream.argtypes = [
                u8p, ctypes.c_int64, u8p, ctypes.c_int32, ctypes.c_int32,
                u64p, u64p,
            ]
        _LIB = lib
    return _LIB


def available() -> bool:
    return _get_lib() is not None


def _as_u8p(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def parse_fasta_native(data: bytes):
    """FASTA bytes -> (codes stream, n_records, n_bases) or None if unavailable."""
    lib = _get_lib()
    if lib is None:
        return None
    src = np.frombuffer(data, dtype=np.uint8)
    out = np.empty(max(src.shape[0], 1), dtype=np.uint8)
    out_len = ctypes.c_int64()
    n_rec = ctypes.c_int64()
    n_bases = ctypes.c_int64()
    status = lib.krust_parse_fasta(
        _as_u8p(src),
        src.shape[0],
        _as_u8p(out),
        ctypes.byref(out_len),
        ctypes.byref(n_rec),
        ctypes.byref(n_bases),
    )
    if status != 0:
        raise FormatError(_ERRORS.get(status, f"parse error {status}"))
    return out[: out_len.value], n_rec.value, n_bases.value


def pack2_native(codes: np.ndarray):
    """2-bit pack a code stream natively -> uint8[ceil(n/4)], or None."""
    lib = _get_lib()
    if lib is None or not hasattr(lib, "krust_pack2"):
        return None
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    n = codes.shape[0]
    out = np.empty(max(-(-n // 4), 1), dtype=np.uint8)
    lib.krust_pack2(_as_u8p(codes), n, _as_u8p(out))
    return out[: -(-n // 4)] if n else out[:0]


def scan_stream_native(
    codes: np.ndarray,
    qual: np.ndarray | None,
    quality_threshold: int | None,
    max_inv: int,
):
    """One-pass pack2 + invalid positions: (packed2, invpos, n_inv) or None.

    ``n_inv > max_inv`` signals early exit (too dirty; partial outputs were
    discarded) — callers collect the positions another way.
    """
    lib = _get_lib()
    if lib is None or not hasattr(lib, "krust_scan_stream"):
        return None
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    n = codes.shape[0]
    packed2 = np.empty(max(-(-n // 4), 1), dtype=np.uint8)
    invpos = np.empty(max(max_inv, 1), dtype=np.int64)
    qp = None
    thr = -1
    if qual is not None and quality_threshold is not None:
        qual = np.ascontiguousarray(qual, dtype=np.uint8)
        qp = _as_u8p(qual)
        thr = quality_threshold
    n_inv = lib.krust_scan_stream(
        _as_u8p(codes),
        n,
        qp,
        thr,
        _as_u8p(packed2),
        invpos.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        max_inv,
    )
    if n_inv > max_inv:
        return packed2[:0], invpos[:0], n_inv
    return packed2[: -(-n // 4)] if n else packed2[:0], invpos[:n_inv], n_inv


# Reused (codes, counts) scratch for count_stream_native: repeat counts at
# a steady batch size would otherwise pay a fresh ~2x8B/window page-fault
# storm per call (measured ~0.3 s per 59M-window pass). One cached pair,
# handed out under a lock; a concurrent second caller allocates transient
# buffers instead of blocking. Pairs above KRUST_SCRATCH_CACHE_MB (default
# 4096) are never cached, so one genome-scale count doesn't pin tens of GB
# for the process lifetime.
_COUNT_SCRATCH: list[np.ndarray] | None = None
_COUNT_SCRATCH_LOCK = threading.Lock()


def _scratch_cache_limit_bytes() -> int:
    try:
        return int(os.environ.get("KRUST_SCRATCH_CACHE_MB", "4096")) * (1 << 20)
    except ValueError:
        return 4096 << 20


def _lease_count_scratch(t: int):
    """-> (out_codes, out_counts); callers hand the pair back when done."""
    global _COUNT_SCRATCH
    if _COUNT_SCRATCH_LOCK.acquire(blocking=False):
        pair = _COUNT_SCRATCH
        _COUNT_SCRATCH = None
        _COUNT_SCRATCH_LOCK.release()
        if pair is not None and pair[0].shape[0] >= t:
            return pair[0], pair[1]
    out_codes = np.empty(t, dtype=np.uint64)
    out_counts = np.empty(t, dtype=np.uint64)
    # eagerly fault the fresh pair in: lazy first-touch costs ~45 us/page
    # on virtualized hosts (~12 s/GB measured) vs ~0.15 s/GB populated
    lib = _get_lib()
    if lib is not None and hasattr(lib, "krust_populate_write"):
        lib.krust_populate_write(_as_u8p(out_codes.view(np.uint8)), out_codes.nbytes)
        lib.krust_populate_write(_as_u8p(out_counts.view(np.uint8)), out_counts.nbytes)
    return out_codes, out_counts


def _return_count_scratch(out_codes: np.ndarray, out_counts: np.ndarray):
    global _COUNT_SCRATCH
    if out_codes.nbytes + out_counts.nbytes > _scratch_cache_limit_bytes():
        return  # too big to pin for the process lifetime
    with _COUNT_SCRATCH_LOCK:
        if _COUNT_SCRATCH is None or _COUNT_SCRATCH[0].shape[0] < out_codes.shape[0]:
            _COUNT_SCRATCH = [out_codes, out_counts]


def count_stream_native(
    codes: np.ndarray,
    qual: np.ndarray | None,
    quality_threshold: int | None,
    k: int,
):
    """Full host count: (sorted unique u64 codes, u64 counts) or None.

    Rolling canonical encode + sort + RLE in one native call — the host
    counting core for machines without an accelerator (same exactness
    semantics as models/engines.count_stream_numpy, differentially tested).
    """
    lib = _get_lib()
    if lib is None or not hasattr(lib, "krust_count_stream"):
        return None
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    n = codes.shape[0]
    if n - k + 1 <= 0:
        return np.zeros(0, np.uint64), np.zeros(0, np.uint64)
    # capacity n (not n-k+1): the threaded roll addresses per-thread
    # segments by window END index, which ranges over [0, n)
    out_codes, out_counts = _lease_count_scratch(n)
    qp = None
    thr = -1
    if qual is not None and quality_threshold is not None:
        qual = np.ascontiguousarray(qual, dtype=np.uint8)
        qp = _as_u8p(qual)
        thr = quality_threshold
    u64p = ctypes.POINTER(ctypes.c_uint64)
    n_unique = lib.krust_count_stream(
        _as_u8p(codes),
        n,
        qp,
        thr,
        k,
        out_codes.ctypes.data_as(u64p),
        out_counts.ctypes.data_as(u64p),
    )
    # compact copies detach the result from the n-sized scratch, which
    # goes back to the (size-capped) cache for the next call
    result = out_codes[:n_unique].copy(), out_counts[:n_unique].copy()
    _return_count_scratch(out_codes, out_counts)
    return result


def parse_fastq_native(data: bytes):
    """FASTQ bytes -> (codes, qual, n_records, n_bases) or None if unavailable."""
    lib = _get_lib()
    if lib is None:
        return None
    src = np.frombuffer(data, dtype=np.uint8)
    cap = max(src.shape[0], 1)
    out_codes = np.empty(cap, dtype=np.uint8)
    out_qual = np.empty(cap, dtype=np.uint8)
    out_len = ctypes.c_int64()
    n_rec = ctypes.c_int64()
    n_bases = ctypes.c_int64()
    status = lib.krust_parse_fastq(
        _as_u8p(src),
        src.shape[0],
        _as_u8p(out_codes),
        _as_u8p(out_qual),
        ctypes.byref(out_len),
        ctypes.byref(n_rec),
        ctypes.byref(n_bases),
    )
    if status != 0:
        raise FormatError(_ERRORS.get(status, f"parse error {status}"))
    return (
        out_codes[: out_len.value],
        out_qual[: out_len.value],
        n_rec.value,
        n_bases.value,
    )


# --- range-parallel ingest (io/native/ingest.cpp) -------------------------------

#: input bytes a parse thread takes: smaller inputs parse on fewer threads,
#: one part or less on one thread
INGEST_PART_BYTES = 16 << 20

#: the most threads one parse takes, as a table pull's chunk does: on an
#: H100's 8-core host a 1.05 GB FASTQ parsed in 1.06-1.26 s on 1 thread,
#: 0.26-0.34 s on 8 and 0.26-0.40 s on 16
INGEST_MAX_THREADS = 8


def ingest_threads(n_bytes: int) -> int:
    """Threads for the parse of ``n_bytes`` of input: one a part (rounded
    up), at most the process's cores and ``INGEST_MAX_THREADS``.
    ``KRUST_NATIVE_THREADS`` forces a count, as it does for the core's
    scan."""
    forced = os.environ.get("KRUST_NATIVE_THREADS")
    if forced is not None:
        try:
            return max(1, min(64, int(forced)))
        except ValueError:
            return 1
    cores = len(os.sched_getaffinity(0))
    return max(1, min(INGEST_MAX_THREADS, cores, -(-n_bytes // INGEST_PART_BYTES)))


def _get_ingest() -> ctypes.CDLL | None:
    global _INGEST, _INGEST_FAILED
    if _INGEST is not None or _INGEST_FAILED:
        return _INGEST
    if os.environ.get("KRUST_NO_NATIVE"):
        _INGEST_FAILED = True
        return None
    with _LOCK:
        if _INGEST is not None or _INGEST_FAILED:
            return _INGEST
        lib = _load(_INGEST_SRC, "libkrust_ingest_")
        if lib is None:
            _INGEST_FAILED = True
            return None
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i64p = ctypes.POINTER(ctypes.c_int64)
        tail = [ctypes.c_int32, ctypes.c_int32, u8p, u8p, i64p, i64p, i64p]
        lib.krust_ingest.restype = ctypes.c_int32
        lib.krust_ingest.argtypes = [u8p, ctypes.c_int64, *tail]
        lib.krust_ingest_fd.restype = ctypes.c_int32
        lib.krust_ingest_fd.argtypes = [ctypes.c_int32, ctypes.c_int64, *tail]
        _INGEST = lib
    return _INGEST


def _ingest(call, n: int, fastq: bool, quality: bool, threads: int):
    """Run one ingest call (its input bound) into fresh outputs of
    capacity ``n`` -> (status, codes, qual, n_records, n_bases)."""
    codes = np.empty(max(n, 1), dtype=np.uint8)
    qual = np.empty(max(n, 1), dtype=np.uint8) if fastq and quality else None
    out_len, n_rec, n_bases = ctypes.c_int64(), ctypes.c_int64(), ctypes.c_int64()
    status = call(n, int(fastq), threads, _as_u8p(codes),
                  None if qual is None else _as_u8p(qual), ctypes.byref(out_len),
                  ctypes.byref(n_rec), ctypes.byref(n_bases))
    m = out_len.value
    return (status, codes[:m], None if qual is None else qual[:m], n_rec.value,
            n_bases.value)


def _ingest_result(status: int, codes, qual, n_rec: int, n_bases: int, threads: int):
    if status < 0:
        raise OSError(-status, os.strerror(-status))
    if status:
        raise FormatError(_ERRORS.get(status, f"parse error {status}"))
    return codes, qual, n_rec, n_bases, threads


def ingest_native(data, fastq: bool, *, quality: bool = True, threads: int | None = None):
    """Parse a whole FASTA/FASTQ input (any bytes-like object) on
    ``threads`` threads (default :func:`ingest_threads`) -> (codes, qual,
    n_records, n_bases, threads), or None without the native library.

    The output of :func:`parse_fasta_native` / :func:`parse_fastq_native`,
    with ``qual`` None for FASTA or when ``quality`` is false (lengths still
    checked). The outputs are fresh arrays: none views ``data``."""
    lib = _get_ingest()
    if lib is None:
        return None
    src = np.frombuffer(data, dtype=np.uint8)
    n = src.size
    threads = ingest_threads(n) if threads is None else threads
    res = _ingest(partial(lib.krust_ingest, _as_u8p(src)), n, fastq, quality, threads)
    del src  # no view of the caller's buffer outlives the call, nor an error's frames
    return _ingest_result(*res, threads)


def ingest_file_native(fd: int, size: int, fastq: bool, *, quality: bool = True,
                       threads: int | None = None):
    """:func:`ingest_native` over the first ``size`` bytes of the open file
    ``fd``, mapped read-only (``MAP_POPULATE``) for the call and unmapped
    before it returns; ``OSError`` when the map fails."""
    lib = _get_ingest()
    if lib is None:
        return None
    threads = ingest_threads(size) if threads is None else threads
    res = _ingest(partial(lib.krust_ingest_fd, fd), size, fastq, quality, threads)
    return _ingest_result(*res, threads)
