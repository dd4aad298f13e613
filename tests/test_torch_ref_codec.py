"""krust_tpu's tests/test_codec.py, run against the port through
krust_tpu's call forms (see tests/torch_reference_suite.py and
tests/torch_reference_forms.py)."""

import random

import numpy as np
import pytest
import torch

import oracle
from krust_tpu_torch.io.packer import pack_buffer_2bit
from krust_tpu_torch.io.reader import streams_from_sequences
from krust_tpu_torch.kmer import unpack_many
from krust_tpu_torch.ops import codec as port_codec
from krust_tpu_torch.ops import count as port_count
from krust_tpu_torch.ops.keys import keys_to_codes, sentinel
from krust_tpu_torch.utils.config import default_device
from torch_reference_suite import load

_STEP = ("_dense_raw_step (krust_tpu/models/engines.py:422), a private engine step; the "
         "port's dense step is K4 alone (ops/codec.encode_dense)")

STATED = {
    "test_packed_2bit_path_matches": _STEP,
    "test_packed_2bit_quality": _STEP,
}

#: each STATED test -> the port's test of its counterpart behaviour
BESIDE = {
    "test_packed_2bit_path_matches": "test_port_packed_2bit_path_matches",
    "test_packed_2bit_quality": "test_port_packed_2bit_quality",
}

globals().update(load("test_codec", STATED))


def _dense_count(streams, k, threshold, block_windows):
    """The dense route step by step: 2-bit rows, K4, then ops/count."""
    dev = default_device()
    got = {}
    for batch in pack_buffer_2bit(streams.codes, streams.qual, k, threshold,
                                  block_windows=block_windows):
        keys = port_codec.encode_dense(torch.from_numpy(batch.packed2).to(dev),
                            torch.from_numpy(batch.badbits).to(dev), k, batch.block_windows)
        s_keys, cnt = port_count.count_runs(keys, keys != sentinel(keys.dtype))
        live = (cnt > 0).cpu().numpy()
        codes64 = keys_to_codes(s_keys.cpu().numpy()[live], k)
        for km, c in zip(unpack_many(codes64, k), cnt.cpu().numpy()[live].tolist()):
            got[km] = got.get(km, 0) + c
    return got


@pytest.mark.parametrize("k", [1, 3, 16, 21, 32])
def test_port_packed_2bit_path_matches(k):
    """The bit-packed dense route equals the oracle."""
    rng = random.Random(900 + k)
    seqs = [oracle.random_dna(rng, rng.randint(0, 200), "ACGTacgtNn") for _ in range(10)]
    streams = streams_from_sequences(seqs)
    assert _dense_count(streams, k, None, 128) == oracle.count_sequences(seqs, k)


def test_port_packed_2bit_quality():
    """Quality folds into the bad bits: the dense route equals the oracle."""
    rng = random.Random(33)
    records = []
    for _ in range(10):
        n = rng.randint(0, 100)
        records.append((oracle.random_dna(rng, n),
                        "".join(chr(rng.randint(33, 73)) for _ in range(n))))
    k, min_q = 5, 20
    streams = streams_from_sequences([s for s, _ in records], [q.encode() for _, q in records])
    assert _dense_count(streams, k, min_q + 33, 64) == oracle.count_sequences(
        records, k, min_quality=min_q)
