"""Property-based tests of the port, mirroring tests/test_properties.py.

Hypothesis-driven invariants over ``krust_tpu_torch``'s own copies of the
host codec, the ``.kmix`` index and the native C++ core, as
``tests/test_properties.py`` holds ``krust_tpu``'s:

- pack/unpack identity (lowercase included), soft-mask = upper case,
  canonical idempotence, RC-equivalence and minimality;
- an arbitrary u64 unpacks to a valid length-k ACGT string;
- pack injectivity under a 1-base mutation;
- random index save/load round trips;
- the native counting core against the numpy oracle on arbitrary dirty
  streams, with and without forced threads.

One differential property on top: random records with N, lowercase and
quality bytes, k drawn from 1..32, through the port's ``BatchEngine`` on
the CPU (every kernel's plain version) on the flat route (its 1/32 gate
lifted, so dirty records stay flat) and the dense route, with the epoch
and the LSM table, against ``krust_tpu``'s ``NumpyEngine`` and the
brute-force oracle in ``tests/oracle.py``: tables exactly equal. The
seeded fuzz harness of the port runs in tests/test_torch_examples.py.
"""

from __future__ import annotations

import os
from unittest import mock

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from krust_tpu.io.reader import streams_from_sequences as jax_streams
from krust_tpu.models.engines import NumpyEngine as JaxNumpyEngine
from krust_tpu_torch.io import packer as port_packer
from krust_tpu_torch.io.reader import streams_from_sequences
from krust_tpu_torch.kmer import (
    canonical_packed,
    pack,
    revcomp_packed,
    unpack_many,
    unpack_to_string,
)
from krust_tpu_torch.models.engines import BatchEngine
from krust_tpu_torch.ops import codec as codec_mod
from krust_tpu_torch.ops import fused_codec as fused_mod
from krust_tpu_torch.utils.config import EngineConfig

import oracle

_DNA = st.text(alphabet="ACGTacgt", min_size=1, max_size=32)
_DNA_UPPER = st.text(alphabet="ACGT", min_size=1, max_size=32)


@settings(max_examples=300, deadline=None)
@given(_DNA)
def test_pack_unpack_identity(s):
    assert unpack_to_string(pack(s), len(s)) == s.upper()


@settings(max_examples=300, deadline=None)
@given(_DNA)
def test_softmask_equals_upper(s):
    assert pack(s) == pack(s.upper())


@settings(max_examples=300, deadline=None)
@given(_DNA_UPPER)
def test_canonical_idempotent_rc_equivalent_minimal(s):
    k = len(s)
    bits = pack(s)
    canon, _ = canonical_packed(bits, k)
    again, again_rc = canonical_packed(canon, k)
    assert again == canon and not again_rc  # idempotence; fwd kept on ties
    rc_bits = revcomp_packed(bits, k)
    canon_rc, _ = canonical_packed(rc_bits, k)
    assert canon_rc == canon  # RC-equivalence
    assert canon <= bits and canon <= rc_bits  # minimality


@settings(max_examples=300, deadline=None)
@given(st.integers(min_value=0, max_value=(1 << 64) - 1), st.integers(1, 32))
def test_unpack_arbitrary_u64_valid(bits, k):
    s = unpack_to_string(bits, k)
    assert len(s) == k
    assert set(s) <= set("ACGT")


@settings(max_examples=200, deadline=None)
@given(_DNA_UPPER, st.data())
def test_pack_injective_under_mutation(s, data):
    k = len(s)
    pos = data.draw(st.integers(0, k - 1))
    repl = data.draw(st.sampled_from([b for b in "ACGT" if b != s[pos]]))
    assert pack(s[:pos] + repl + s[pos + 1 :]) != pack(s)


@settings(max_examples=50, deadline=None)
@given(
    st.dictionaries(
        st.integers(0, (1 << 16) - 1),
        st.integers(1, (1 << 63)),
        min_size=0,
        max_size=64,
    )
)
def test_index_roundtrip_random_maps(counts):
    from krust_tpu_torch.index import KmerIndex, deserialize_index, serialize_index

    idx = KmerIndex(8, counts)
    loaded = deserialize_index(serialize_index(idx))
    assert loaded.k.get() == 8
    assert loaded.counts == counts


@settings(max_examples=150, deadline=None)
@given(
    codes_list=st.lists(st.integers(min_value=0, max_value=5), min_size=1, max_size=400),
    k=st.integers(1, 32),
    threads=st.sampled_from([None, 1, 2, 3]),
)
def test_native_count_matches_numpy_oracle(codes_list, k, threads):
    """The port's copy of the native core (every k regime, optional forced
    threading) against the port's numpy oracle on arbitrary dirty
    streams (4 and 5 both mean invalid)."""
    from krust_tpu_torch.io import native
    from krust_tpu_torch.models.engines import count_stream_numpy

    codes = np.array([min(c, 4) for c in codes_list], dtype=np.uint8)
    env = {} if threads is None else {"KRUST_NATIVE_THREADS": str(threads)}
    with mock.patch.dict(os.environ, env):
        if threads is None:
            os.environ.pop("KRUST_NATIVE_THREADS", None)
        got = native.count_stream_native(codes, None, None, k)
    assert got is not None, "the port's native core did not build"
    exp = count_stream_numpy(codes, None, k)
    np.testing.assert_array_equal(got[0], exp[0].astype(np.uint64))
    np.testing.assert_array_equal(got[1], exp[1].astype(np.uint64))


# --- the differential property: the port's engine against krust_tpu and the oracle ---

_RECORD = st.text(alphabet="ACGTNacgtn", min_size=0, max_size=150)


@st.composite
def _reads(draw):
    """Records with N and lowercase, each with Phred+33 quality bytes
    ('!'..'J'), k in 1..32 and an optional Q20 filter."""
    seqs = draw(st.lists(_RECORD, min_size=1, max_size=4))
    quals = [bytes(draw(st.lists(st.integers(33, 74), min_size=len(s), max_size=len(s))))
             for s in seqs]
    return seqs, quals, draw(st.integers(1, 32)), draw(st.sampled_from([None, 20]))


def _gate(route, real):
    """``scan_stream`` with the 1/32 gate lifted (flat: the flat route for
    any stream whose geometry it can hold) or shut (dense: the dense route
    for every stream)."""
    def scan_stream(codes, qual, thr, max_inv, *a, **kw):
        lifted = codes.shape[0] if max_inv >= 0 else max_inv
        return real(codes, qual, thr, lifted if route == "flat" else -1, *a, **kw)
    return scan_stream


@pytest.mark.parametrize("epoch_sort", [True, False], ids=["epoch", "lsm"])
@pytest.mark.parametrize("route", ["flat", "dense"])
@settings(max_examples=40, deadline=None)
@given(reads=_reads())
def test_engine_matches_jax_numpy_and_oracle(route, epoch_sort, reads):
    seqs, quals, k, min_quality = reads
    calls = {"flat": 0, "dense": 0}
    real_flat, real_dense = fused_mod.encode_windows, codec_mod.encode_dense

    def flat(*a):
        calls["flat"] += 1
        return real_flat(*a)

    def dense(*a):
        calls["dense"] += 1
        return real_dense(*a)

    gate = _gate(route, port_packer.scan_stream)
    cfg = EngineConfig(block_windows=64, batch_rows=4, device="cpu",
                       use_epoch_sort=epoch_sort)
    with mock.patch.object(port_packer, "scan_stream", gate), \
            mock.patch.object(fused_mod, "encode_windows", flat), \
            mock.patch.object(codec_mod, "encode_dense", dense):
        got = BatchEngine(cfg).count(streams_from_sequences(seqs, quals), k, min_quality)
    exp = JaxNumpyEngine().count(jax_streams(seqs, quals), k, min_quality)
    np.testing.assert_array_equal(got.codes, exp.codes)
    np.testing.assert_array_equal(got.counts, exp.counts)
    records = list(zip(seqs, (q.decode() for q in quals))) if min_quality else seqs
    want = oracle.count_sequences(records, k, min_quality)
    assert dict(zip(unpack_many(got.codes, k), got.counts.tolist())) == want
    n_bases = sum(map(len, seqs)) + len(seqs) - 1  # one separator between records
    if n_bases >= k:
        assert calls[route] > 0 and calls["dense" if route == "flat" else "flat"] == 0
