"""K6: the count-of-counts (histogram) of a table's int32 counts.

Replaces no ``krust_tpu`` kernel: ``krust_tpu`` takes the histogram on the
host, ``np.unique`` over the pulled counts, a sort of every count. Added
because that sort was the largest host step of ``-f histogram`` output,
while the counts lie on the card until the table pull. The CUDA
kernel is ``csrc/histogram.cu``: each block keeps ``BINS`` u32 bins in
shared memory, a warp's equal values add as one atomic
(``__match_any_sync``), and the blocks add their nonzero bins to global
u64 bins. Counts outside ``[0, BINS)`` are counted there; when there are
any, a second launch gathers them into a buffer of exactly that size and
the host counts them, so the result is exact for every int32 count.

Bound on the H100: bytes, 4 B a count read once; the scratch is
``BINS + 1`` u64 and the gathered counts.

:func:`count_histogram` launches the kernel for CUDA tensors (the gather,
when it runs, counts with its call as one launch on the wrapper's
counter) and runs :func:`count_histogram_plain` for CPU tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from ..histogram import CountHistogram
from . import _cuda

#: counts below this have a bin of their own on the card: 32 KB of shared
#: memory a block
BINS = 8192


def _assemble(bins: np.ndarray, over: np.ndarray) -> CountHistogram:
    """The histogram of the counts whose in-range bins are ``bins`` and
    whose other values are ``over`` (any order)."""
    values = np.flatnonzero(bins)
    freqs = bins[values].astype(np.int64)
    if over.size:
        o_values, o_freqs = np.unique(over.astype(np.int64), return_counts=True)
        neg = o_values < 0
        values = np.concatenate([o_values[neg], values, o_values[~neg]])
        freqs = np.concatenate([o_freqs[neg], freqs, o_freqs[~neg]])
    return CountHistogram(values.astype(np.int64), freqs.astype(np.int64))


def count_histogram_plain(counts: torch.Tensor) -> CountHistogram:
    """Plain PyTorch version of :func:`count_histogram` (same contract, on
    any device)."""
    c = counts.reshape(-1).to(torch.int64)
    low = (c >= 0) & (c < BINS)
    return _assemble(torch.bincount(c[low], minlength=BINS).cpu().numpy(),
                     c[~low].cpu().numpy())


def count_histogram(counts: torch.Tensor) -> CountHistogram:
    """The count-of-counts of ``counts``: every distinct value ascending
    and how many entries hold it, as int64 numpy arrays.

    Args:
      counts: int32 [n], contiguous, on one device (a table's counts).

    Synchronises with the card to read the bins (and, when counts lie
    outside the bins, their number).
    """
    if counts.device.type == "cpu":
        return count_histogram_plain(counts)
    _cuda.require_cuda("count_histogram", counts)
    if counts.dtype != torch.int32 or counts.dim() != 1:
        raise ValueError("count_histogram: one-dimensional int32 counts")
    n = counts.numel()
    if n == 0:
        return count_histogram_plain(counts)
    dev = counts.device
    lib = _cuda.library()
    stream = _cuda.stream_of(counts)
    acc = torch.empty(BINS + 1, dtype=torch.int64, device=dev)
    err = lib.krust_count_histogram(dev.index, counts.data_ptr(), n, BINS, acc.data_ptr(),
                                    stream)
    count_histogram.launches += 1
    _cuda.check("count_histogram", err)
    acc = acc.cpu().numpy()
    n_over = int(acc[BINS])
    over = np.zeros(0, np.int32)
    if n_over:
        out = torch.empty(n_over, dtype=torch.int32, device=dev)
        pos = torch.empty(1, dtype=torch.int64, device=dev)
        err = lib.krust_histogram_over(dev.index, counts.data_ptr(), n, BINS, out.data_ptr(),
                                       pos.data_ptr(), stream)
        _cuda.check("count_histogram", err)
        over = out.cpu().numpy()
    return _assemble(acc[:BINS], over)


count_histogram.launches = 0
