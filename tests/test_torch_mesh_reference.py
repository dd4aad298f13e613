"""The sharded count over 4 CPU slots (``krust_tpu_torch.parallel``) against
the benchmark's plain reference (``portbench.reference``), on read sets
that ``portbench.gen.write_reads`` writes.

``api.count_kmers_sharded_result`` over a mesh of 4 CPU slots, the
benchmark cell ``readset_k21_4gpu``'s call, equals the reference's table
entry for entry at k = 16, 21 and 32, on clean reads (the flat route) and
on N-rich reads (the dense route). The shares tie to the whole: after the
exchange each slot holds exactly the reference's entries that
``_owner_of`` gives it, the four are disjoint and their union is the
table. The exchange's and the gather's spans fire once an exchange, once
a destination slot and once a gather.
"""

import numpy as np
import pytest
import torch

from krust_tpu_torch import api
from krust_tpu_torch.io.format import SequenceFormat
from krust_tpu_torch.ops import codec as codec_mod
from krust_tpu_torch.ops import fused_codec as fused_mod
from krust_tpu_torch.ops import table as table_mod
from krust_tpu_torch.ops.keys import codes_to_keys, keys_to_codes
from krust_tpu_torch.parallel import sharded as sharded_mod
from krust_tpu_torch.parallel.mesh import make_mesh
from krust_tpu_torch.utils import tracing
from krust_tpu_torch.utils.config import EngineConfig
from portbench import gen, reference

SLOTS = 4
CPU = torch.device("cpu")
KS = [16, 21, 32]
#: (error rate, N rate): readset_clean's rates (flat route), and N past the
#: 1/32 line of invalid bases (dense route)
KINDS = {"clean": (0.005, 0.0005), "n-rich": (0.005, 0.06)}
QUALITY = {"phred": [37], "first": [1.0], "last": [1.0]}
#: 2,048 windows a batch: ~26 batches of the 52,000 windows, dealt over
#: the 4 slots, so that every slot's part holds the genome's keys
GEOMETRY = dict(block_windows=256, batch_rows=8)


def _reads(tmp_path, seed, n_rate=0.0005, error_rate=0.005):
    path = str(tmp_path / "reads.fq")
    gen.write_reads(path, seed, CPU, total_bases=60_000, genome_bases=4_000,
                    read_length=150, error_rate=error_rate, n_rate=n_rate, quality=QUALITY)
    return path


def _reference(path, k):
    """The reference's table: (u64 codes, counts), sorted by code."""
    data = torch.from_numpy(np.fromfile(path, np.uint8))
    keys, counts = reference.count_table(data, True, k, None)
    return reference.codes_of(keys).numpy().view(np.uint64), counts.numpy()


def _count(path, k):
    return api.count_kmers_sharded_result(
        path, k, SequenceFormat.AUTO, None, mesh=make_mesh(devices=["cpu"] * SLOTS),
        config=EngineConfig(device="cpu", **GEOMETRY))


@pytest.fixture
def spans():
    """The fields of the sharded path's spans, by name, one entry a span."""
    names = ("sharded_exchange", "exchange_cut", "exchange_merge", "gather_shards")
    seen = {name: [] for name in names}

    def collect(kind, name, fields):
        if kind == "span" and name in seen:
            seen[name].append(fields)

    tracing.add_collector(collect)
    yield seen
    tracing.remove_collector(collect)


@pytest.fixture
def shards(monkeypatch):
    """The slots' shards of every exchange, as (u64 codes, counts) pairs."""
    got = []
    real = sharded_mod._exchange

    def exchange(parts, mesh, k):
        out = real(parts, mesh, k)
        got.append([(keys_to_codes(keys[:n].numpy(), k), cnt[:n].numpy())
                    for keys, cnt, n in out])
        return out

    monkeypatch.setattr(sharded_mod, "_exchange", exchange)
    return got


@pytest.fixture
def route(monkeypatch):
    """Codec calls by route: flat (K1) and dense (K4)."""
    calls = {"flat": 0, "dense": 0}
    for name, mod, fn in (("flat", fused_mod, "encode_windows"),
                          ("dense", codec_mod, "encode_dense")):
        real = getattr(mod, fn)

        def counted(*a, _real=real, _name=name):
            calls[_name] += 1
            return _real(*a)

        monkeypatch.setattr(mod, fn, counted)
    return calls


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("k", KS)
def test_sharded_count_equals_the_reference(tmp_path, route, k, kind):
    error_rate, n_rate = KINDS[kind]
    path = _reads(tmp_path, 2**31 + 1000 * k + len(kind), n_rate, error_rate)
    codes, counts = _reference(path, k)
    got = _count(path, k)
    assert codes.size > 1000
    dense = kind == "n-rich"
    assert (route["dense"] > 0) == dense and (route["flat"] > 0) == (not dense)
    np.testing.assert_array_equal(got.codes, codes)
    np.testing.assert_array_equal(got.counts, counts.astype(np.uint64))


@pytest.mark.parametrize("k", KS)
def test_each_slots_share_is_the_references_entries_it_owns(tmp_path, shards, k):
    path = _reads(tmp_path, 2**31 + 77 + k)
    codes, counts = _reference(path, k)
    got = _count(path, k)
    assert len(shards) == 1  # one table lifetime: one exchange
    owner = sharded_mod._owner_of(torch.from_numpy(codes_to_keys(codes, k)), SLOTS).numpy()
    held = []
    for slot, (s_codes, s_counts) in enumerate(shards[0]):
        mine = owner == slot
        assert 0 < s_codes.size < codes.size
        np.testing.assert_array_equal(s_codes, codes[mine])
        np.testing.assert_array_equal(s_counts, counts[mine])
        held.append(s_codes)
    union = np.concatenate(held)
    assert np.unique(union).size == union.size == codes.size  # disjoint, and the whole
    np.testing.assert_array_equal(np.sort(union), got.codes)


@pytest.mark.parametrize("short", [False, True], ids=["one-lifetime", "short-lifetimes"])
def test_the_exchange_and_gather_spans_fire_once_each(tmp_path, monkeypatch, spans, short):
    """One ``exchange_cut`` an exchange, one ``exchange_merge`` a destination
    slot of it, one ``gather_shards`` a gather; table lifetimes cut short
    (``EPOCH_WINDOW_LIMIT``) exchange and gather several times."""
    if short:
        batch = GEOMETRY["block_windows"] * GEOMETRY["batch_rows"]
        monkeypatch.setattr(table_mod, "EPOCH_WINDOW_LIMIT", 3 * SLOTS * batch)
    path = _reads(tmp_path, 2**31 + 5)
    codes, counts = _reference(path, 21)
    got = _count(path, 21)
    np.testing.assert_array_equal(got.codes, codes)
    exchanges = len(spans["sharded_exchange"])
    assert (exchanges > 1) == short and exchanges >= 1
    assert len(spans["exchange_cut"]) == exchanges
    assert len(spans["gather_shards"]) == exchanges
    assert [f["slot"] for f in spans["exchange_merge"]] == list(range(SLOTS)) * exchanges
    assert all(f["slots"] == SLOTS for f in spans["exchange_cut"])
    assert all(f["elapsed_s"] >= 0 for name in spans for f in spans[name])
