"""K2's share of its roofline: the least time for the bytes the problem
needs (each counted window's int64 key read once, each distinct entry's
key and int32 count written once; ``portbench.roofline.rle_bytes``) over
the device time of K2's kernels (``rle_tiles``, ``rle_tail``)."""

from portbench import roofline

KERNELS = ("rle_tiles", "rle_tail")


def read(window):
    if window.trace is None:
        return None
    return roofline.share_pct(roofline.rle_bytes(window.windows, window.distinct),
                              window.trace.seconds(KERNELS), roofline.rle_ops(window.windows))
