"""The k = 15 assembly cell (``assembly_k15_hist``): the cell cut tiny on the
CPU reads ``correct`` across two epochs and a part merge; faults planted in
the part merge and the pull read ``correct`` false; the new readers read
their spans, and each int32 roofline reads at most 100% at the kernels'
bound; and a CUDA case runs the cell at a small size on the card.

The tiny cell's batches are shrunk (the entry's default ``EngineConfig``
replaced by one of 16 rows of 1,024 windows) and the epoch size patched,
so that a CPU pass makes two epochs and one part merge, as a pass of the
cell on the card does at the card's budget.

    python3 -m pytest portbench/tests/test_portbench_k15.py -q
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from portbench import roofline, run, spec, trace
from portbench.run import Window

from .helpers import CPU, ROOT

CELL = "assembly_k15_hist"
SECONDS = 0.3
TINY_BASES = 400_000
GEOMETRY = dict(block_windows=1024, batch_rows=16)
#: metric -> the port's span it reads
SPANS = {"part_merge_s_per_gbase": "part_merge",
         "epoch_resolve_s_per_gbase": "epoch_resolve"}
ROOFLINES = ("codec_i32_roofline_pct", "rle_i32_roofline_pct", "merge_i32_roofline_pct")


def _cell(total_bases: int) -> spec.Cell:
    cell = spec.Cell(spec.benchmark(ROOT), CELL)
    cell.config = dict(cell.config, total_bases=total_bases)
    return cell


class _Epochs:
    """The port's span fields and its table's counters over a run."""

    def __init__(self, table):
        self.table, self.seen = table, []

    def __call__(self, kind, name, fields):
        if kind == "span":
            self.seen.append((name, fields))

    def __enter__(self):
        from krust_tpu_torch.utils import tracing

        self.counters = (self.table.EpochTable.flushes, self.table.EpochTable.part_merges)
        tracing.add_collector(self)
        return self

    def __exit__(self, *exc):
        from krust_tpu_torch.utils import tracing

        tracing.remove_collector(self)
        self.flushes = self.table.EpochTable.flushes - self.counters[0]
        self.part_merges = self.table.EpochTable.part_merges - self.counters[1]

    def fields(self, name):
        return [f for n, f in self.seen if n == name]


@pytest.fixture
def tiny_port(monkeypatch):
    """The port on the CPU with small batches, and an epoch size that splits
    a pass of the tiny cell into two epochs."""
    monkeypatch.setenv("KRUST_PLATFORM", "cpu")
    monkeypatch.delenv("KRUST_EPOCH_ENTRIES", raising=False)
    from krust_tpu_torch import api
    from krust_tpu_torch.ops import table
    from krust_tpu_torch.utils.config import EngineConfig

    monkeypatch.setattr(api, "EngineConfig", lambda: EngineConfig(**GEOMETRY))
    # 400,000 bases: ~25 batches of 16,384 raw keys; the first epoch ends past 60%
    monkeypatch.setattr(table, "EPOCH_ENTRY_LIMIT", 15 * 16 * 1024)
    return table


def test_the_tiny_cell_is_correct_over_two_epochs_and_a_part_merge(tiny_port):
    with _Epochs(tiny_port) as ep:
        out = run.run_cell(_cell(TINY_BASES), 2**31 + 211, SECONDS, False, CPU)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 1
    assert all(c["value"] == 0 == c["limit"] for c in out["checks"].values())
    assert set(out["checks"]) == {"entries_off", "outputs_off", "passes_failed"}
    passes = out["attempted"] + 1  # the warm-up pass
    assert (ep.flushes, ep.part_merges) == (2 * passes, passes)
    assert {f["key_bytes"] for n, f in ep.seen
            if n in ("epoch_flush", "part_merge", "pull_table")} == {4}
    assert not any(f["retuned"] for f in ep.fields("epoch_resolve"))


def test_the_traced_tiny_cell_reads_its_span_metrics(tiny_port):
    out = run.run_cell(_cell(TINY_BASES), 2**31 + 223, SECONDS, True, CPU)
    assert out["correct"]
    for metric in SPANS:
        assert out["metrics"][metric]["value"] > 0
        assert out["metrics"][metric]["unit"] == "s/Gbase"
    # no CUDA kernel on the CPU: the rooflines find nothing and are left out
    assert not set(ROOFLINES) & set(out["metrics"])


def _merge_drops_the_second_part(monkeypatch, table):
    def dropped(a, b):
        return table.rle_compact(a[0], a[1])

    monkeypatch.setattr(table, "_merge_compact", dropped)


def _int32_count_altered_at_the_pull(monkeypatch, table):
    pull = table._pull_table

    def altered(t_keys, t_cnt, n, k):
        assert t_cnt.dtype == torch.int32 and t_keys.dtype == torch.int32
        t_cnt = t_cnt.clone()
        t_cnt[n // 2] += 1
        return pull(t_keys, t_cnt, n, k)

    monkeypatch.setattr(table, "_pull_table", altered)


@pytest.mark.parametrize("fault", [_merge_drops_the_second_part,
                                   _int32_count_altered_at_the_pull])
def test_a_fault_in_the_epochs_or_the_pull_is_not_correct(tiny_port, monkeypatch, fault):
    fault(monkeypatch, tiny_port)
    out = run.run_cell(_cell(TINY_BASES), 2**31 + 227, SECONDS, False, CPU)
    assert out["correct"] is False
    assert out["checks"]["entries_off"]["value"] > 0
    assert out["checks"]["outputs_off"]["value"] >= 1


@pytest.mark.parametrize("metric", sorted(SPANS))
def test_a_span_reader_reads_its_span_per_gbase(metric):
    read = spec.metric_reader(metric)
    w = Window()
    w.bases = 4_000_000_000
    w.spans = {"epoch_flush": 5.0, **{s: 100.0 for s in SPANS.values() if s != SPANS[metric]}}
    assert read(w) is None
    w.spans[SPANS[metric]] = 3.0
    assert read(w) == pytest.approx(0.75)


def test_the_new_entries_list_only_the_cell():
    bench = spec.benchmark(ROOT)
    entries = {m["name"]: m for m in bench["per_layer"]}
    layers = {"part_merge_s_per_gbase": "engine: part merge",
              "epoch_resolve_s_per_gbase": "engine: epoch"}
    for name in (*SPANS, *ROOFLINES):
        m = entries[name]
        assert m["workloads"] == [CELL] and m["moves"] == "mbases_per_s"
        assert callable(spec.metric_reader(name))
        if name in SPANS:
            assert (m["unit"], m["better"], m["source"], m["layer"]) == (
                "s/Gbase", "lower", "program_span", layers[name])
        else:
            assert (m["unit"], m["better"], m["source"], m["layer"]) == (
                "%", "higher", "device_trace", "kernels")
    others = [m for m in bench["per_layer"] if m["name"] not in (*SPANS, *ROOFLINES)]
    assert not any(CELL in m.get("workloads", []) for m in others)
    cell = spec.Cell(bench, CELL)
    assert (cell.chips, cell.workload["traffic"], cell.config["k"]) == (1, "assembly_fasta", 15)


def _ev(name, start, end, dev):
    return SimpleNamespace(name=name, time_range=SimpleNamespace(start=start, end=end),
                           device_type=dev, is_user_annotation=False)


def test_each_int32_roofline_reads_at_most_100_at_the_kernels_bound(tiny_port, tmp_path):
    """A tiny count's own work, each kernel role given the least time its
    bytes and operations take on the card: the readers' floors never pass
    the work the kernels do."""
    from portbench import gen, reference

    cell = _cell(TINY_BASES)
    path = str(tmp_path / "input.fa")
    made = gen.write_input(path, 2**31 + 229, CPU, cell.config, cell.traffic)
    with _Epochs(tiny_port) as ep:
        result = spec.entry("count_with_input").run(path, cell.config)
    keys, counts = reference.count_table(
        torch.from_numpy(np.fromfile(path, np.uint8)), False, 15, None)
    assert result.distinct == keys.numel()
    k, bases, windows, distinct = 15, made["bases"], int(counts.sum()), keys.numel()
    raw = sum(f["pending"] for f in ep.fields("epoch_flush"))
    uniques = sum(f["unique_kmers"] for f in ep.fields("epoch_resolve"))
    merged = sum(f["entries"] for f in ep.fields("part_merge"))
    assert raw >= windows and uniques >= distinct and merged >= distinct

    def least_us(n_bytes, n_ops):
        return 1e6 * max(n_bytes / roofline.HBM_BYTES_PER_S, n_ops / roofline.ALU_OPS_PER_S)

    # what the kernels do at least: K4 reads the 2-bit input and writes a key
    # a raw position; K2 reads each raw key and writes each epoch's entries;
    # K3b reads and writes each entry (a key and a count) of every merge
    work = {"void encode_dense_kernel<int>(...)": least_us(bases / 4 + 4 * raw,
                                                           (2 * k + 10) * raw),
            "void rle_tiles<int, true>(...)": least_us(4 * raw + 8 * uniques, 2 * raw),
            "void merge_tiles<int, true>(...)": least_us(16 * merged, merged)}
    t, events = 0.0, [_ev(trace.WINDOW, 0.0, 1e9, "cpu")]
    for name, us in work.items():
        events.append(_ev(name, t, t + us, "cuda"))
        t += us
    w = Window()
    w.k, w.bases, w.windows, w.distinct = k, bases, windows, distinct
    w.trace = trace.reduce(events, set(), "cuda", "cpu")
    for name in ROOFLINES:
        got = spec.metric_reader(name)(w)
        assert 0 < got <= 100 + 1e-9, (name, got)
    # an int64 kernel is not read
    w.trace = trace.reduce([events[0], _ev("void encode_dense_kernel<long>(...)", 0, 5, "cuda")],
                           set(), "cuda", "cpu")
    assert all(spec.metric_reader(name)(w) is None for name in ROOFLINES)


@pytest.mark.cuda
@pytest.mark.parametrize("traced", [False, True])
def test_the_cell_on_the_card_at_a_small_size(monkeypatch, traced):
    """96 Mbases, the epoch pinned at 64 Mi raw keys: two dense batches,
    then one, so two epochs and a part merge a pass, as at the cell's
    size."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from krust_tpu_torch.ops import table

    monkeypatch.setenv("KRUST_EPOCH_ENTRIES", str(1 << 26))
    cell = _cell(96_000_000)
    with _Epochs(table) as ep:
        out = run.run_cell(cell, 2**31 + 233, 2.0, traced, torch.device("cuda"))
    assert out["correct"] and out["failed"] == 0
    assert out["device"]["platform"] == "gpu" and out["device"]["memory_peak_bytes"] > 0
    want = {m["name"] for m in (cell.per_layer if traced else cell.end_to_end)}
    assert set(out["metrics"]) == want
    passes = out["attempted"] + 1
    assert (ep.flushes, ep.part_merges) == (2 * passes, passes)
    assert out["route"]["encode_dense"] > 0 and out["route"]["merge_sorted"] > 0
    if traced:
        for name in ROOFLINES:
            assert 0 < out["metrics"][name]["value"] <= 100, name
        names = " ".join(n for n, _ in out["breakdown"]["device_ops"])
        assert "<int" in names
