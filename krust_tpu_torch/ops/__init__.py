"""Device ops: the codec, RLE and merge kernels (CUDA, each with a plain
PyTorch version), the public codec ``encode_blocks`` and its host helpers,
the sort-based counting functions and the count tables."""

from .codec import combine64, encode_blocks, split64
from .count import count_unique, merge_weighted
from .fused_codec import encode_windows, encode_windows_plain
from .merge import merge_sorted, merge_sorted_plain
from .rle import rle_compact, rle_compact_plain

__all__ = [
    "combine64",
    "count_unique",
    "encode_blocks",
    "encode_windows",
    "encode_windows_plain",
    "merge_sorted",
    "merge_sorted_plain",
    "merge_weighted",
    "rle_compact",
    "rle_compact_plain",
    "split64",
]
