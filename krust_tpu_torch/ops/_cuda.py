"""Build and bind the hand-written CUDA kernels under ``krust_tpu_torch/csrc``.

``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a`` (one process per source,
all started together) and links them into one shared library with a plain
C interface, at first use, into ``krust_tpu_torch/_build/`` (keyed by a
hash of the sources, so an edit rebuilds and an unchanged checkout reuses
the build). The library is loaded with ``ctypes``; every
pointer argument is declared ``c_void_p``. Nothing here runs at import
time: the CPU-only test lane imports every module without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
import time

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
_BUILD = os.path.join(_PKG, "_build")
_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None

#: seconds the last build took (0.0 when the cached library was reused)
build_seconds = 0.0

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
]
#: compile-only: ptxas reports each kernel's registers, shared memory and
#: spills, kept beside the library (see :func:`ptxas_report`)
_PTXAS_FLAGS = ["-Xptxas", "-v"]

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_INT = ctypes.c_int
#: argument types; the first is the CUDA device index of the tensors
_SIGNATURES = {
    "krust_encode_windows_i32": [_INT, _P, _P, _I64, _I64, _INT, _I64, _P, _P],
    "krust_encode_windows_i64": [_INT, _P, _P, _I64, _I64, _INT, _I64, _P, _P],
    "krust_rle_i32": [_INT, _P, _P, _I64, _P, _P, _P, _P, _P],
    "krust_rle_i64": [_INT, _P, _P, _I64, _P, _P, _P, _P, _P],
    "krust_merge_i32": [_INT, _P, _P, _I64, _P, _P, _I64, _P, _P, _P, _P],
    "krust_merge_i64": [_INT, _P, _P, _I64, _P, _P, _I64, _P, _P, _P, _P],
    "krust_merge_keys_u32": [_INT, _P, _P, _I64, _P, _P, _P],
    "krust_encode_dense_i32": [_INT, _P, _P, _I64, _I64, _I64, _INT, _I64, _P, _P],
    "krust_encode_dense_i64": [_INT, _P, _P, _I64, _I64, _I64, _INT, _I64, _P, _P],
    "krust_encode_codes_i32": [_INT, _P, _P, _I64, _I64, _I64, _INT, _I64, _P, _P, _P],
    "krust_encode_codes_i64": [_INT, _P, _P, _I64, _I64, _I64, _INT, _I64, _P, _P, _P],
    "krust_count_histogram": [_INT, _P, _I64, _INT, _P, _P],
    "krust_histogram_over": [_INT, _P, _I64, _INT, _P, _P, _P],
}
#: tile and scratch sizes (int64 results)
_SIZES = {
    "krust_rle_tile": [_INT],
    "krust_rle_scratch_bytes": [_I64, _INT],
    "krust_encode_windows_tile": [],
    "krust_merge_tile": [_INT],
}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the CUDA kernels build from "
            "krust_tpu_torch/csrc at first use"
        )
    return found


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(_CSRC, "*.cu")))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + _PTXAS_FLAGS).encode())
    for path in sorted(glob.glob(os.path.join(_CSRC, "*.cu*"))):
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode())
            h.update(f.read())
    return h.hexdigest()[:16]


def _lib_path() -> str:
    return os.path.join(_BUILD, f"libkrust_kernels_{_digest()}.so")


def _build() -> str:
    global build_seconds
    os.makedirs(_BUILD, exist_ok=True)
    lib_path = _lib_path()
    if os.path.exists(lib_path):
        build_seconds = 0.0
        return lib_path
    start = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=_BUILD) as obj_dir:
        objs = [
            os.path.join(obj_dir, os.path.basename(src) + ".o") for src in _sources()
        ]
        procs = [
            subprocess.Popen(
                [nvcc_path(), *NVCC_FLAGS, *_PTXAS_FLAGS, "-c", src, "-o", obj],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            )
            for src, obj in zip(_sources(), objs)
        ]
        errors, logs = [], []
        for src, proc in zip(_sources(), procs):
            _, err = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"{os.path.basename(src)} ({proc.returncode}):\n{err}")
            logs.append(err)
        if errors:
            raise RuntimeError("nvcc failed: " + "\n".join(errors))
        with open(lib_path + ".ptxas.txt", "w") as f:
            f.write("".join(logs))
        tmp = f"{lib_path}.tmp{os.getpid()}"
        link = subprocess.run(
            [nvcc_path(), *NVCC_FLAGS, "-shared", "-o", tmp, *objs],
            capture_output=True, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stderr}")
    os.replace(tmp, lib_path)
    build_seconds = time.perf_counter() - start
    return lib_path


def library() -> ctypes.CDLL:
    """The kernel library, built on first call (thread-safe)."""
    global _LIB
    if _LIB is not None:
        return _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(_build())
            for name, args in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = args
                fn.restype = ctypes.c_int
            for name, args in _SIZES.items():
                fn = getattr(lib, name)
                fn.argtypes = args
                fn.restype = ctypes.c_int64
            lib.krust_cuda_error_string.argtypes = [ctypes.c_int]
            lib.krust_cuda_error_string.restype = ctypes.c_char_p
            _LIB = lib
    return _LIB


def ptxas_report() -> list[dict]:
    """Registers, shared memory and spill bytes of every kernel in the
    built library, from ptxas's report at build time (demangled names when
    the toolkit's ``cu++filt`` is there); empty if there is no report."""
    path = _lib_path() + ".ptxas.txt"
    if not os.path.exists(path):
        return []
    rows, cur = [], None
    with open(path) as f:
        for line in f:
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                cur = {"kernel": m.group(1)}
                rows.append(cur)
                continue
            if cur is None:
                continue
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m:
                cur["spill_store_bytes"], cur["spill_load_bytes"] = map(int, m.groups())
            m = re.search(r"Used (\d+) registers", line)
            if m:
                cur["registers"] = int(m.group(1))
                smem = re.search(r"(\d+) bytes smem", line)
                cur["smem_bytes"] = int(smem.group(1)) if smem else 0
    filt = os.path.join(os.path.dirname(nvcc_path()), "cu++filt")
    if rows and os.path.exists(filt):
        out = subprocess.run([filt], input="\n".join(r["kernel"] for r in rows),
                             capture_output=True, text=True)
        names = out.stdout.splitlines()
        if out.returncode == 0 and len(names) == len(rows):
            for r, name in zip(rows, names):
                r["kernel"] = name
    return rows


def check(name: str, err: int) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err:
        msg = library().krust_cuda_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def stream_of(t: torch.Tensor) -> int:
    """The raw handle of PyTorch's current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Every tensor on one CUDA device and contiguous, else raise."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name}: tensors must share one CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
