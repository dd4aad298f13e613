"""The codec role's share of its roofline: the least time the card could
take for the bytes the problem needs (the input's 2-bit form, one int64
key a counted window; ``portbench.roofline.codec_bytes``) over the device
time of the codec kernels (K1 ``encode_windows_kernel`` on the flat
route, K4 ``encode_dense_kernel`` on the dense one)."""

from portbench import roofline

KERNELS = ("encode_windows_kernel", "encode_dense_kernel")


def read(window):
    if window.trace is None:
        return None
    return roofline.share_pct(roofline.codec_bytes(window.bases, window.windows),
                              window.trace.seconds(KERNELS),
                              roofline.codec_ops(window.windows, window.k))
