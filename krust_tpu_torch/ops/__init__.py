"""Device ops: the codec, RLE and merge kernels (CUDA, each with a plain
PyTorch version) and the epoch-sort table."""

from .fused_codec import encode_windows, encode_windows_plain
from .merge import merge_sorted, merge_sorted_plain
from .rle import rle_compact, rle_compact_plain

__all__ = [
    "encode_windows",
    "encode_windows_plain",
    "merge_sorted",
    "merge_sorted_plain",
    "rle_compact",
    "rle_compact_plain",
]
