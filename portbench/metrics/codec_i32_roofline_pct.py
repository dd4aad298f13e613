"""The codec role's share of its roofline at int32 keys (k <= 16): the
least time the card could take for the bytes the problem needs (the
input's 2-bit form, one 4 B key a counted window) over the device time of
the codec kernels' int32 instantiations (K1 ``encode_windows_kernel<int>``
on the flat route, K4 ``encode_dense_kernel<int>`` on the dense one).

``codec_roofline_pct`` reckons 8 B keys, which a k <= 16 count never
writes: on such a count it would read up to twice the truth."""

from portbench import roofline

KERNELS = ("encode_windows_kernel<int", "encode_dense_kernel<int")


def codec_bytes(bases: int, windows: int) -> float:
    """The input's 2-bit form read, one int32 key a counted window written."""
    return bases / 4 + 4 * windows


def read(window):
    if window.trace is None:
        return None
    return roofline.share_pct(codec_bytes(window.bases, window.windows),
                              window.trace.seconds(KERNELS),
                              roofline.codec_ops(window.windows, window.k))
