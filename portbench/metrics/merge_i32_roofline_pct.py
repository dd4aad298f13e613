"""K3b's share of its roofline: the part merges of a count at int32 keys
(k <= 16) past one epoch, over the device time of K3's int32
instantiations (``merge_partition<int``, ``merge_tiles<int``).

The bytes come from the sizes of the problem, never from the launches:
each distinct entry (an int32 key and an int32 count) read once and
written once, 16 B a distinct entry, at 3.35 TB/s. Every distinct entry
passes through at least one part merge once a count spans two epochs, so
this floor is never above what K3b moves and the share never reads over
100%. One compare an output entry is the operations' bound, which the
bytes' bound exceeds."""

from portbench import roofline

KERNELS = ("merge_partition<int", "merge_tiles<int")


def merge_bytes(distinct: int) -> float:
    """Each distinct entry's 4 B key and 4 B count, read once, written once."""
    return 16 * distinct


def merge_ops(distinct: int) -> float:
    """One compare a distinct entry of the output."""
    return distinct


def read(window):
    if window.trace is None:
        return None
    return roofline.share_pct(merge_bytes(window.distinct), window.trace.seconds(KERNELS),
                              merge_ops(window.distinct))
