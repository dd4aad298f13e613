"""krust_tpu's tests/test_pallas_fused.py, run against the port through
krust_tpu's call forms (see tests/torch_reference_suite.py and
tests/torch_reference_forms.py)."""

import numpy as np
import pytest
import torch

from krust_tpu_torch.io.packer import pack2_full
from krust_tpu_torch.kmer import INVALID_CODE
from krust_tpu_torch.ops import codec as port_codec
from krust_tpu_torch.ops.fused_codec import TAIL_BYTES, encode_windows
from krust_tpu_torch.ops.keys import keys_to_codes, sentinel
from krust_tpu_torch.utils.config import default_device
from torch_reference_suite import load

_STEP = ("_count_flat_step (krust_tpu/models/engines.py:312), a private engine step with "
         "its unfused branch; the port's flat step is K1 alone (ops/fused_codec."
         "encode_windows), which poisons the windows itself")

STATED = {
    "test_fused_step_matches_unfused": _STEP,
    "test_fused_step_covered_mask": _STEP,
    "test_fused_step_poisons_k_windows_per_invalid": _STEP,
}

#: each STATED test -> the port's test of its counterpart behaviour
BESIDE = {
    "test_fused_step_matches_unfused": "test_port_flat_step_matches_dense_codec",
    "test_fused_step_covered_mask": "test_port_flat_step_covered_mask",
    "test_fused_step_poisons_k_windows_per_invalid":
        "test_port_flat_step_poisons_k_windows_per_invalid",
}

globals().update(load("test_pallas_fused", STATED))

ROWS, W = 8, 512


def _flat_step(stream, k, covered):
    """K1 over one flat batch of ROWS x W windows: the stream's packed
    bytes and its invalid positions -> (keys, their uint64 codes), the
    sentinel key's code where a window is poisoned."""
    n = ROWS * W
    packed = np.zeros(n // 4 + TAIL_BYTES + 16, np.uint8)
    p = pack2_full(stream)
    packed[: p.shape[0]] = p
    inv = np.flatnonzero(stream >= INVALID_CODE).astype(np.int32)
    invpos = np.concatenate([inv, np.full(8, n + k, np.int32)])
    dev = default_device()
    keys = encode_windows(torch.from_numpy(packed).to(dev), torch.from_numpy(invpos).to(dev),
                          covered, k, n)
    return keys, keys_to_codes(keys.cpu().numpy(), k)


@pytest.mark.parametrize("k", [5, 16, 21, 32])
def test_port_flat_step_matches_dense_codec(k):
    """A dirty stream's flat step equals the byte-row codec window for
    window: the code where the window is clean, the sentinel elsewhere."""
    rng = np.random.default_rng(7 + k)
    stream = rng.integers(0, 4, size=ROWS * W + k - 1, dtype=np.uint8)
    stream[rng.choice(stream.shape[0], size=25, replace=False)] = INVALID_CODE
    _, got = _flat_step(stream, k, ROWS * W)
    rows = np.lib.stride_tricks.sliding_window_view(stream, W + k - 1)[::W][:ROWS]
    hi, lo, valid = port_codec.encode_blocks(torch.from_numpy(np.ascontiguousarray(rows)), k)
    exp = (hi.numpy().astype(np.uint64) << np.uint64(32)) | lo.numpy().astype(np.uint64)
    exp[~valid.numpy()] = np.uint64(2**32 - 1 if k <= 16 else 2**64 - 1)  # the sentinel key's
    np.testing.assert_array_equal(got, exp.reshape(-1))


def test_port_flat_step_covered_mask():
    """Windows at index >= covered are the sentinel."""
    k = 21
    stream = np.random.default_rng(3).integers(0, 4, size=ROWS * W + k - 1, dtype=np.uint8)
    keys, _ = _flat_step(stream, k, 100)
    assert int((keys != sentinel(keys.dtype)).sum()) == 100


def test_port_flat_step_poisons_k_windows_per_invalid():
    """One interior invalid base poisons exactly k windows."""
    k = 7
    stream = np.zeros(ROWS * W + k - 1, np.uint8)
    stream[1000] = INVALID_CODE
    keys, _ = _flat_step(stream, k, ROWS * W)
    assert int((keys == sentinel(keys.dtype)).sum()) == k
