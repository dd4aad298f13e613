"""Device seconds of the epoch sort (``torch.sort`` in
``ops/table._epoch_concat_sort_rle``: CUB's radix sort kernels, and the
index fill that ``torch.sort`` launches beside them), per Gbase counted."""

#: parts of the kernel names that torch.sort launches on CUDA (torch 2.11:
#: cub's DeviceRadixSort{Histogram,ExclusiveSum,Onesweep}Kernel and
#: fill_reverse_indices_kernel)
KERNELS = ("RadixSort", "fill_reverse_indices_kernel")


def read(window):
    if window.trace is None:
        return None
    s = window.trace.seconds(KERNELS)
    return s / (window.bases / 1e9) if s > 0 else None
