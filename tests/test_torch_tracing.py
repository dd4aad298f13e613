"""The spans inside the port's engine and output, on the CPU device engine.

A count through ``api.count_with_input`` emits ``flat_scan`` (the flat
route's scan, also where it ends in the dense route), ``feed_pack`` and
``feed_stage`` (the feed: on the ``krust-feed`` thread, on the caller's at
``feed_depth`` 0), ``feed_wait`` (the caller waiting on the feed; none at
depth 0) and ``pull_table`` (the pull with the keys' decode inside it: no
``decode_codes`` span of its own); the histogram output emits
``histogram``. The caller's spans nest inside the
caller's own profiler range, which the benchmark's idle attribution reads,
and a collector changes no result.
"""

import io
import threading

import numpy as np
import pytest
import torch

from krust_tpu_torch import api
from krust_tpu_torch.io.format import SequenceFormat
from krust_tpu_torch.io.input import Input
from krust_tpu_torch.io.packer import flat_batches
from krust_tpu_torch.io.reader import parse_to_streams, read_input_bytes
from krust_tpu_torch.models.engines import _Feed
from krust_tpu_torch.output import OutputFormat, output_packed
from krust_tpu_torch.utils import tracing
from krust_tpu_torch.utils.config import EngineConfig

import oracle

K = 15
GEOMETRY = dict(block_windows=256, batch_rows=8)
MAIN = ("flat_scan", "feed_wait", "pull_table")
FEED = ("feed_pack", "feed_stage")
#: share of bases that are N on each route: the dense one is past 1/32
N_SHARE = {"flat": 0.002, "dense": 0.08}


def _records(route: str, seed: int = 7):
    rng = np.random.default_rng(seed)
    records = []
    for i in range(12):
        seq = rng.choice(np.array(list("ACGT")), 900 + 37 * i)
        seq[rng.random(seq.shape[0]) < N_SHARE[route]] = "N"
        records.append("".join(seq))
    return records


@pytest.fixture(scope="module", params=sorted(N_SHARE))
def fasta(request, tmp_path_factory):
    records = _records(request.param)
    path = tmp_path_factory.mktemp("spans") / f"{request.param}.fa"
    path.write_text("".join(f">r{i}\n{s}\n" for i, s in enumerate(records)))
    return request.param, str(path), records


class _Spans:
    """Collects (name, thread name) of every span while installed."""

    def __init__(self):
        self.seen = []

    def __call__(self, kind, name, fields):
        if kind == "span":
            self.seen.append((name, threading.current_thread().name))

    def __enter__(self):
        tracing.add_collector(self)
        return self

    def __exit__(self, *exc):
        tracing.remove_collector(self)

    def threads(self, name):
        return {t for n, t in self.seen if n == name}

    def count(self, name):
        return sum(n == name for n, _ in self.seen)


def _count(path, depth):
    cfg = EngineConfig(device="cpu", feed_depth=depth, **GEOMETRY)
    return api.count_with_input(Input.from_path(path), K, SequenceFormat.AUTO, None, cfg)


def test_the_fixture_takes_the_route_it_names(fasta):
    route, path, _ = fasta
    streams = parse_to_streams(read_input_bytes(path), SequenceFormat.FASTA)
    flat = flat_batches(streams.codes, streams.qual, K, None, **GEOMETRY)
    assert (flat is None) == (route == "dense")


@pytest.mark.parametrize("depth", [2, 0])
def test_a_count_emits_the_engine_spans(fasta, depth):
    _, path, records = fasta
    caller = threading.current_thread().name
    with _Spans() as spans:
        got = _count(path, depth)
    assert got.to_string_dict() == oracle.count_sequences(records, K)
    for name in ("flat_scan", "pull_table"):
        assert spans.threads(name) == {caller}, name
    feeder = "krust-feed" if depth > 0 else caller
    for name in FEED:
        assert spans.threads(name) == {feeder}, name
    # one pack a batch and the generator's end; one stage a batch
    batches = spans.count("encode_count_batch")
    assert batches >= 2
    assert spans.count("feed_stage") == batches
    assert spans.count("feed_pack") == batches + 1
    if depth > 0:
        assert spans.threads("feed_wait") == {caller}
        assert spans.count("feed_wait") == batches + 1  # the last get takes the end
    else:
        assert spans.count("feed_wait") == 0
    names = [n for n, _ in spans.seen]
    # the decode runs inside the one pull, which closes the count's spans
    assert names.count("pull_table") == 1 and "decode_codes" not in names
    assert names.index("pull_table") > names.index("flat_scan")


def test_the_histogram_output_emits_its_span(fasta):
    _, path, records = fasta
    result = _count(path, 2)
    sink = io.BytesIO()
    with _Spans() as spans:
        output_packed(result, OutputFormat.HISTOGRAM, 1, out=sink)
    assert [n for n, _ in spans.seen] == ["histogram"]
    hist = {}
    for c in oracle.count_sequences(records, K).values():
        hist[c] = hist.get(c, 0) + 1
    assert sink.getvalue() == "".join(f"{c}\t{f}\n" for c, f in sorted(hist.items())).encode()


def test_caller_spans_nest_inside_the_callers_profiler_range(fasta):
    """The benchmark attributes idle device time to the innermost host
    range open: the engine's main-thread spans must be ranges of the
    profiler's own clock, on the caller's thread, inside its range."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    _, path, _ = fasta
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("caller"):
            _count(path, 2)
    events = [e for e in prof.events() if e.device_type == DeviceType.CPU]
    outer = [e for e in events if e.name == "caller"]
    assert len(outer) == 1
    o = outer[0]
    for name in MAIN:
        inner = [e for e in events if e.name == name]
        assert inner, name
        for e in inner:
            assert e.thread == o.thread, name
            assert o.time_range.start <= e.time_range.start
            assert e.time_range.end <= o.time_range.end


@pytest.mark.parametrize("depth", [2, 0])
def test_a_collector_changes_no_result(fasta, depth):
    _, path, _ = fasta
    plain = _count(path, depth)
    with _Spans() as spans:
        traced = _count(path, depth)
    assert spans.seen
    np.testing.assert_array_equal(traced.codes, plain.codes)
    np.testing.assert_array_equal(traced.counts, plain.counts)


@pytest.mark.parametrize("depth", [2, 0])
def test_a_raising_batch_generator_still_closes_its_pack_span(depth):
    """A generator that raises mid-stream reaches the consumer, and the
    ``feed_pack`` span it raised in is closed and emitted."""

    def gen():
        yield 1
        raise RuntimeError("packer failed")

    got = []
    with _Spans() as spans:
        with pytest.raises(RuntimeError, match="packer failed"):
            with _Feed(gen(), lambda b: b * 10, depth) as feed:
                for item in feed:
                    got.append(item)
    assert got == [10]
    assert spans.count("feed_pack") == 2
    assert spans.count("feed_stage") == 1
