"""K2's share of its roofline at int32 keys (k <= 16): the least time for
the bytes the problem needs (each counted window's 4 B key read once, each
distinct entry's 4 B key and 4 B count written once) over the device time
of K2's int32 instantiations (``rle_tiles<int``, ``rle_tail<int``): the
epoch flushes' and the part merges' re-compaction alike.

``rle_roofline_pct`` reckons 8 B keys and would read up to twice the
truth on a k <= 16 count."""

from portbench import roofline

KERNELS = ("rle_tiles<int", "rle_tail<int")


def rle_bytes(windows: int, distinct: int) -> float:
    """Each counted window's int32 key read, each distinct entry's int32 key
    and int32 count written."""
    return 4 * windows + 8 * distinct


def read(window):
    if window.trace is None:
        return None
    return roofline.share_pct(rle_bytes(window.windows, window.distinct),
                              window.trace.seconds(KERNELS), roofline.rle_ops(window.windows))
