"""Device seconds of device-to-host copies (the table pull,
``ops/table._pull_table``), per Gbase counted."""

KERNELS = ("Memcpy DtoH",)


def read(window):
    if window.trace is None:
        return None
    s = window.trace.seconds(KERNELS)
    return s / (window.bases / 1e9) if s > 0 else None
