"""Build and bind the hand-written CUDA kernels under ``krust_tpu_torch/csrc``.

``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a`` into one shared library
with a plain C interface, at first use, into ``krust_tpu_torch/_build/``
(keyed by a hash of the sources, so an edit rebuilds and an unchanged
checkout reuses the build). The library is loaded with ``ctypes``; every
pointer argument is declared ``c_void_p``. Nothing here runs at import
time: the CPU-only test lane imports every module without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
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
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_INT = ctypes.c_int
#: argument types; the first is the CUDA device index of the tensors
_SIGNATURES = {
    "krust_encode_windows_i32": [_INT, _P, _P, _I64, _I64, _INT, _I64, _P, _P],
    "krust_encode_windows_i64": [_INT, _P, _P, _I64, _I64, _INT, _I64, _P, _P],
    "krust_rle_i32": [_INT, _P, _P, _I64, _P, _P, _P, _P, _P, _P],
    "krust_rle_i64": [_INT, _P, _P, _I64, _P, _P, _P, _P, _P, _P],
    "krust_merge_i32": [_INT, _P, _P, _I64, _P, _P, _I64, _P, _P, _P],
    "krust_merge_i64": [_INT, _P, _P, _I64, _P, _P, _I64, _P, _P, _P],
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
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(glob.glob(os.path.join(_CSRC, "*.cu*"))):
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode())
            h.update(f.read())
    return h.hexdigest()[:16]


def _build() -> str:
    global build_seconds
    os.makedirs(_BUILD, exist_ok=True)
    lib_path = os.path.join(_BUILD, f"libkrust_kernels_{_digest()}.so")
    if os.path.exists(lib_path):
        build_seconds = 0.0
        return lib_path
    tmp = f"{lib_path}.tmp{os.getpid()}"
    start = time.perf_counter()
    proc = subprocess.run(
        [nvcc_path(), *NVCC_FLAGS, "-o", tmp, *_sources()],
        capture_output=True,
        text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
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
            lib.krust_rle_tile.argtypes = []
            lib.krust_rle_tile.restype = ctypes.c_int64
            lib.krust_cuda_error_string.argtypes = [ctypes.c_int]
            lib.krust_cuda_error_string.restype = ctypes.c_char_p
            _LIB = lib
    return _LIB


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
