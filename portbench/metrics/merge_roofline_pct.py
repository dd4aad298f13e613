"""K3's share of its roofline: the least time for the bytes any design of
the sharded count must merge, over the device time of K3's kernels
(``merge_partition``, ``merge_tiles``) on every card.

The bytes come from the sizes of the problem, never from the launches:
each distinct entry (an int64 key and an int32 count) read once and
written once, 24 B a distinct entry, at one card's 3.35 TB/s. However the
exchange is built, the whole table's distinct entries pass through at
least one merge, so this floor is never above what K3 moves and the share
never reads over 100%; the device time is summed over the cards, and
each card moves its part at most at that rate. One compare an output
entry is the operations' bound, which the bytes' bound exceeds."""

from portbench import roofline

KERNELS = ("merge_partition", "merge_tiles")


def merge_bytes(distinct: int) -> float:
    """Each distinct entry's 8 B key and 4 B count, read once, written once."""
    return 24 * distinct


def merge_ops(distinct: int) -> float:
    """One compare a distinct entry of the output."""
    return distinct


def read(window):
    if window.trace is None:
        return None
    return roofline.share_pct(merge_bytes(window.distinct), window.trace.seconds(KERNELS),
                              merge_ops(window.distinct))
