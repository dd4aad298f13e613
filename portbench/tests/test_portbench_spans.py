"""The readers of the port's engine and output spans over a hand-built
window: nothing without their span, the span's seconds per Gbase with it;
and each of their ``per_layer`` entries names a reader found by name."""

import pytest

from portbench import spec
from portbench.run import Window

from .helpers import ROOT

#: metric -> the port's span it reads
SPANS = {"flat_scan_s_per_gbase": "flat_scan",
         "feed_pack_s_per_gbase": "feed_pack",
         "feed_stage_s_per_gbase": "feed_stage",
         "feed_wait_s_per_gbase": "feed_wait",
         "decode_s_per_gbase": "decode_codes",
         "histogram_s_per_gbase": "histogram"}


@pytest.mark.parametrize("metric", sorted(SPANS))
def test_a_span_reader_reads_its_span_per_gbase(metric):
    read = spec.metric_reader(metric)
    w = Window()
    w.bases = 4_000_000_000
    w.spans = {"read_sequences": 9.0, **{s: 100.0 for s in SPANS.values() if s != SPANS[metric]}}
    assert read(w) is None
    w.spans[SPANS[metric]] = 3.0
    assert read(w) == pytest.approx(0.75)


@pytest.mark.parametrize("metric", sorted(SPANS))
def test_a_span_metric_is_an_entry_with_its_reader(metric):
    entries = {m["name"]: m for m in spec.benchmark(ROOT)["per_layer"]}
    m = entries[metric]
    assert callable(spec.metric_reader(m["name"]))
    assert (m["unit"], m["better"], m["source"], m["moves"]) == (
        "s/Gbase", "lower", "program_span", "mbases_per_s")
    cells = ["assembly_k31_hist"] if metric == "histogram_s_per_gbase" else \
        ["readset_k21_clean", "assembly_k31_hist"]
    assert m["workloads"] == cells
