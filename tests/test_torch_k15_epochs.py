"""Genome-shaped counts at k = 15, 16 and 17 across epoch flushes and part
merges, against the benchmark's plain reference (``portbench/reference.py``).

The input is a small GRCh38-shaped FASTA from the benchmark's generator
(``portbench.gen.write_genome``: 24 records, 4.9% N in runs, soft-masked
repeat copies), which takes the dense route. The epoch size is patched
(``ops/table.EPOCH_ENTRY_LIMIT``) and the geometry shrunk, as
``tests/test_torch_sizing.py`` does, so that a count makes one epoch, two
epochs and one part merge, or more than ``max_parts`` + 1 epochs with part
merges inside the stream; a repeat-dominated genome makes the one-shot
retune of the epoch size fire. Both key regimes meet at k = 16 | 17 (int32
keys, then int64). Each count's table and histogram equal the reference's,
and the table's counters (``EpochTable.flushes``, ``EpochTable.part_merges``)
and spans (``epoch_flush``, ``epoch_resolve``, ``part_merge``) read the
epochs and merges the batches imply.
"""

import io
import json
import os

import numpy as np
import pytest
import torch

from krust_tpu_torch import api
from krust_tpu_torch.io.format import SequenceFormat
from krust_tpu_torch.io.input import Input
from krust_tpu_torch.io.packer import flat_batches, pack_buffer_2bit
from krust_tpu_torch.io.reader import parse_to_streams, read_input_bytes
from krust_tpu_torch.ops import table as table_mod
from krust_tpu_torch.output import OutputFormat, output_packed
from krust_tpu_torch.utils import tracing
from krust_tpu_torch.utils.config import EngineConfig
from portbench import gen, reference

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
GEOMETRY = dict(block_windows=1024, batch_rows=16)
BASES = 1_000_000
#: the repeat-dominated genome: identical copies of one consensus with 1%
#: unique sequence between them, so an epoch holds ~30 raw keys a distinct key
REPEATS = [{"class": "LINE", "share": 0.99, "mean_length": 3000, "consensus_length": 6000}]
MAX_PARTS = table_mod.EpochTable(15, device=CPU)._max_parts


def _config():
    with open(os.path.join(ROOT, "portbench", "configs", "grch38_repeats_k15.json")) as f:
        return json.load(f)


def _genome(path, repeats, divergence, seed):
    cfg = _config()
    gen.write_genome(str(path), seed, CPU, total_bases=BASES, line=60,
                     n_run=[10_000, 200_000], n_share=cfg["n_share"], repeats=repeats,
                     divergence=divergence)
    return str(path)


@pytest.fixture(scope="module")
def genomes(tmp_path_factory):
    d = tmp_path_factory.mktemp("k15")
    cfg = _config()
    return {"grch38": _genome(d / "grch38.fa", cfg["repeats"], cfg["divergence"], 2**31 + 41),
            "repeats": _genome(d / "repeats.fa", REPEATS, [0.0, 0.0], 2**31 + 43)}


def _batch_keys(path, k):
    """Raw keys of each batch the count adds (the dense route's batches)."""
    streams = parse_to_streams(read_input_bytes(path), SequenceFormat.FASTA)
    assert flat_batches(streams.codes, None, k, None, **GEOMETRY) is None  # dense
    return [b.packed2.shape[0] * b.block_windows
            for b in pack_buffer_2bit(streams.codes, None, k, None, **GEOMETRY)]


def _flushes(sizes, limit):
    """Epoch flushes of batches of ``sizes`` raw keys at a fixed limit."""
    flushes, pending = 0, 0
    for n in sizes:
        pending += n
        if pending >= limit:
            flushes, pending = flushes + 1, 0
    return flushes + (pending > 0)


def _reference(path, k):
    data = torch.from_numpy(np.fromfile(path, np.uint8))
    keys, counts = reference.count_table(data, False, k, None)
    return (reference.codes_of(keys).numpy().view(np.uint64), counts.numpy(),
            reference.histogram_bytes(counts))


#: regime -> (genome, epoch limit from the batches' raw keys, or None: the default)
REGIMES = {
    "one": ("grch38", None),
    "two": ("grch38", lambda sizes: sum(sizes[: len(sizes) * 3 // 5])),
    "many": ("grch38", lambda sizes: sum(sizes) // (MAX_PARTS + 4)),
    "retune": ("repeats", lambda sizes: sum(sizes) // 3),
}


@pytest.mark.parametrize("regime", sorted(REGIMES))
@pytest.mark.parametrize("k", [15, 16, 17])
def test_epochs_and_part_merges_match_the_reference(monkeypatch, genomes, k, regime):
    name, limit_of = REGIMES[regime]
    path = genomes[name]
    sizes = _batch_keys(path, k)
    monkeypatch.delenv("KRUST_EPOCH_ENTRIES", raising=False)
    limit = table_mod.EPOCH_ENTRY_LIMIT
    if limit_of is not None:
        limit = limit_of(sizes)
        monkeypatch.setattr(table_mod, "EPOCH_ENTRY_LIMIT", limit)
    monkeypatch.setattr(table_mod.EpochTable, "ADAPT_MIN", 1 << 10)
    seen = []
    collect = lambda kind, n, f: seen.append((n, f)) if kind == "span" else None  # noqa: E731
    flushes0, merges0 = table_mod.EpochTable.flushes, table_mod.EpochTable.part_merges
    tracing.add_collector(collect)
    try:
        got = api.count_with_input(Input.from_path(path), k, SequenceFormat.AUTO, None,
                                   EngineConfig(device="cpu", **GEOMETRY))
    finally:
        tracing.remove_collector(collect)
    flushes = table_mod.EpochTable.flushes - flushes0
    merges = table_mod.EpochTable.part_merges - merges0

    codes, counts, hist = _reference(path, k)
    np.testing.assert_array_equal(got.codes, codes)
    np.testing.assert_array_equal(got.counts, counts.astype(np.uint64))
    sink = io.BytesIO()
    output_packed(got, OutputFormat("histogram"), 1, out=sink)
    assert sink.getvalue() == hist

    names = [n for n, _ in seen]
    key_bytes = 4 if k <= 16 else 8
    assert names.count("epoch_flush") == flushes == names.count("epoch_resolve")
    assert names.count("part_merge") == merges == flushes - 1
    for n, f in seen:
        if n in ("epoch_flush", "part_merge", "pull_table"):
            assert f["key_bytes"] == key_bytes, n
    resolves = [f for n, f in seen if n == "epoch_resolve"]
    assert [f["raw"] for f in resolves] == [f["pending"] for n, f in seen
                                            if n == "epoch_flush"]
    assert sum(f["raw"] for f in resolves) == sum(sizes)
    assert all(0 < f["unique_kmers"] <= got.distinct for f in resolves)
    # the one retune, at the first epoch's resolve: to 16 x its distinct
    # count where that is below the limit (a single epoch's at the finish)
    target = table_mod.EpochTable.ADAPT_DUP_TARGET * resolves[0]["unique_kmers"]
    assert [f["retuned"] for f in resolves] == [target < limit] + [False] * (flushes - 1)
    if regime == "retune":
        # ~30 raw keys a distinct key: smaller epochs from the third on
        assert resolves[0]["retuned"] and flushes > _flushes(sizes, limit)
    else:
        assert flushes == _flushes(sizes, limit)
    if regime == "one":
        assert flushes == 1
    elif regime == "two":
        assert flushes == 2
    elif regime == "many":
        assert flushes > MAX_PARTS + 1
        # parts merged inside the stream, before the last epoch's flush
        last_flush = len(names) - 1 - names[::-1].index("epoch_flush")
        assert "part_merge" in names[:last_flush]
    windows = int(counts.sum())
    if name == "grch38":  # unique sequence and diverged copies: mostly distinct
        assert got.distinct > windows // 2
    else:
        assert windows > 16 * got.distinct
