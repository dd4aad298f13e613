"""The four-card cell ``readset_k21_4gpu`` on the CPU: its entry over 4 CPU
slots gives a correct run, the comparison sees faults planted in the
exchange and the gather, and its readers read a hand-built window."""

from types import SimpleNamespace

import pytest
import torch

from portbench import gen, roofline, run, spec, trace
from portbench.run import Window

from .helpers import CPU, ROOT

CELL = "readset_k21_4gpu"
SECONDS = 0.3
#: the cell cut to a size a CPU test holds (its genome kept under the reads'
#: coverage, so that every slot sees the genome's keys)
TINY = {"total_bases": 300_000, "genome_bases": 20_000}
#: metric -> the port's span it reads
SPANS = {"exchange_cut_s_per_gbase": "exchange_cut",
         "exchange_merge_s_per_gbase": "exchange_merge",
         "gather_s_per_gbase": "gather_shards"}


def _tiny():
    cell = spec.Cell(spec.benchmark(ROOT), CELL)
    cell.config = dict(cell.config, **TINY)
    return cell


@pytest.fixture
def sharded(monkeypatch):
    """The port on the CPU, with batches of 8,192 windows, so that the
    tiny input is dealt over the 4 slots."""
    monkeypatch.setenv("KRUST_PLATFORM", "cpu")
    from krust_tpu_torch.parallel import sharded
    from krust_tpu_torch.utils.config import EngineConfig

    monkeypatch.setattr(sharded, "EngineConfig",
                        lambda: EngineConfig(block_windows=1024, batch_rows=8))
    return sharded


def test_the_cell_asks_for_four_cards_and_its_files_are_found():
    cell = _tiny()
    assert cell.chips == 4 and cell.config["devices"] == 4
    assert cell.traffic["entry"] == "count_sharded"
    assert {m["name"] for m in cell.per_layer} == set(SPANS) | {"merge_roofline_pct"}


@pytest.mark.parametrize("dealt", [False, True], ids=["one-batch", "dealt"])
def test_a_sound_run_is_correct(monkeypatch, request, dealt):
    if dealt:
        request.getfixturevalue("sharded")
    else:
        monkeypatch.setenv("KRUST_PLATFORM", "cpu")
    out = run.run_cell(_tiny(), 2**31 + 41, SECONDS, False, CPU)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 1
    assert set(out["metrics"]) == {"mbases_per_s", "peak_device_gib", "peak_host_gib",
                                   "setup_s"}
    assert out["device"]["count"] == 4
    assert all(c["value"] == 0 == c["limit"] for c in out["checks"].values())


def test_a_traced_run_reads_the_spans(sharded):
    out = run.run_cell(_tiny(), 2**31 + 43, SECONDS, True, CPU)
    assert out["correct"]
    # no CUDA trace on the CPU: K3's roofline finds no device time
    assert set(out["metrics"]) == set(SPANS)
    assert all(m["value"] > 0 for m in out["metrics"].values())


def _one_destination_dropped(monkeypatch, sharded):
    """Every slot's entries owned by slot 1 left out of its cut."""
    real = sharded._by_owner

    def by_owner(part, n):
        keys, cnt, per_owner = real(part, n)
        start = int(per_owner[0])
        end = start + int(per_owner[1])
        keep = torch.cat([torch.arange(start), torch.arange(end, keys.numel())])
        per_owner = per_owner.clone()
        per_owner[1] = 0
        return keys[keep], cnt[keep], per_owner

    monkeypatch.setattr(sharded, "_by_owner", by_owner)


def _shard_merged_twice(monkeypatch, sharded):
    """Slot 0's shard merged into the gathered table twice."""
    real = sharded._gather

    def gather(shards, device, k):
        shards.append(shards[0])
        return real(shards, device, k)

    monkeypatch.setattr(sharded, "_gather", gather)


def _pass_fails(monkeypatch, sharded):
    from portbench.entries import count_sharded

    real, calls = count_sharded.run, []

    def flaky(path, cfg):
        calls.append(1)
        if len(calls) == 2:  # the window's first pass (the first call warms up)
            raise RuntimeError("planted failure")
        return real(path, cfg)

    monkeypatch.setattr(count_sharded, "run", flaky)


@pytest.mark.parametrize("fault", [_one_destination_dropped, _shard_merged_twice,
                                   _pass_fails])
def test_a_fault_in_the_sharded_path_is_not_correct(monkeypatch, sharded, fault):
    fault(monkeypatch, sharded)
    out = run.run_cell(_tiny(), 2**31 + 47, SECONDS, False, CPU)
    assert out["correct"] is False
    assert any(c["value"] > c["limit"] for c in out["checks"].values())


def test_the_merge_floor_is_below_what_the_sharded_path_merges(tmp_path, monkeypatch,
                                                               sharded):
    """K3's roofline bytes, 24 B a distinct entry, against the bytes that
    the exchange's and the gather's merges read and write in one count:
    the floor is the lower."""
    from portbench.entries import count_sharded
    from portbench.metrics.merge_roofline_pct import merge_bytes

    moved = []
    real = sharded.merge_sorted

    def counted(a_keys, a_cnt, b_keys, b_cnt):
        n = a_keys.numel() + b_keys.numel()
        moved.append(2 * n * (a_keys.element_size() + a_cnt.element_size()))
        return real(a_keys, a_cnt, b_keys, b_cnt)

    monkeypatch.setattr(sharded, "merge_sorted", counted)
    cell = _tiny()
    path = str(tmp_path / "input.fq")
    gen.write_input(path, 2**31 + 53, CPU, cell.config, cell.traffic)
    result = count_sharded.run(path, cell.config)
    assert len(moved) > 4  # the exchange's merges and the gather's
    assert 0 < merge_bytes(result.distinct) <= sum(moved)


@pytest.mark.parametrize("metric", sorted(SPANS))
def test_a_span_reader_reads_its_span_per_gbase(metric):
    read = spec.metric_reader(metric)
    w = Window()
    w.bases = 2_000_000_000
    w.spans = {"sharded_exchange": 9.0,
               **{s: 100.0 for s in SPANS.values() if s != SPANS[metric]}}
    assert read(w) is None
    w.spans[SPANS[metric]] = 3.0
    assert read(w) == pytest.approx(1.5)


def _ev(name, start, end, dev):
    return SimpleNamespace(name=name, time_range=SimpleNamespace(start=start, end=end),
                           device_type=dev, is_user_annotation=False)


def test_the_merge_roofline_reads_k3s_device_time():
    read = spec.metric_reader("merge_roofline_pct")
    w = Window()
    w.bases, w.windows, w.distinct = 1_000_000_000, 860_000_000, 100_000_000
    assert read(w) is None
    events = [_ev(trace.WINDOW, 0, 10e6, "cpu"),
              _ev("void merge_partition<long>(long const*, long, long*)", 1e6, 1.001e6, "cuda"),
              _ev("void merge_tiles<long, true>(long const*, int const*)", 2e6, 2.003e6, "cuda"),
              _ev("void merge_tiles<long, true>(long const*, int const*)", 3e6, 3.002e6, "cuda"),
              _ev("rle_tiles<long>", 4e6, 4.5e6, "cuda")]
    w.trace = trace.reduce(events, set(), "cuda", "cpu")
    # 24 B x 100M distinct at 3.35 TB/s over 6 ms of K3
    assert read(w) == pytest.approx(100 * 2.4e9 / roofline.HBM_BYTES_PER_S / 0.006)
    w.trace = trace.reduce(events[:1] + events[-1:], set(), "cuda", "cpu")
    assert read(w) is None  # no K3 on the path


@pytest.mark.parametrize("metric", sorted(SPANS) + ["merge_roofline_pct"])
def test_a_sharded_metric_is_an_entry_of_the_new_cell_alone(metric):
    entries = {m["name"]: m for m in spec.benchmark(ROOT)["per_layer"]}
    m = entries[metric]
    span = metric in SPANS
    assert (m["unit"], m["better"], m["source"], m["moves"]) == (
        "s/Gbase" if span else "%", "lower" if span else "higher",
        "program_span" if span else "device_trace", "mbases_per_s")
    assert m["workloads"] == [CELL]
