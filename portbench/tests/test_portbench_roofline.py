"""Roofline byte counts on hand-worked shapes, the trace's reduction on a
hand-made trace, and the metric readers over both."""

from types import SimpleNamespace

import pytest

from portbench import roofline, spec, trace
from portbench.run import Window

CPU, CUDA = "cpu", "cuda"


def test_codec_and_rle_bytes():
    # 400 bases -> 100 B of 2-bit input; 90 counted windows -> 720 B of keys
    assert roofline.codec_bytes(400, 90) == 100 + 720
    # 90 raw keys read (720 B); 30 distinct (int64 key + int32 count) written (360 B)
    assert roofline.rle_bytes(90, 30) == 720 + 360
    assert roofline.share_pct(3.35e12, 1.0) == pytest.approx(100.0)
    assert roofline.share_pct(3.35e9, 0.002) == pytest.approx(50.0)
    assert roofline.share_pct(1.0, 0.0) is None
    # 100 windows at k = 21: 52 operations each
    assert roofline.codec_ops(100, 21) == 5200
    assert roofline.rle_ops(90) == 180
    # operations bound where they take longer than the bytes
    assert roofline.share_pct(0.0, 1.0, 67e12) == pytest.approx(100.0)
    assert roofline.share_pct(3.35e12, 1.0, 6.7e12) == pytest.approx(100.0)


def _ev(name, start, end, dev):
    return SimpleNamespace(name=name, time_range=SimpleNamespace(start=start, end=end),
                           device_type=dev, is_user_annotation=False)


def _trace():
    # times in microseconds: the window 0..10 s; kernels and copies on the device
    events = [
        _ev(trace.WINDOW, 0, 10e6, CPU),
        _ev("read_sequences", 0, 4e6, CPU),
        _ev("portbench.count", 0, 8e6, CPU),
        _ev("pull_table", 6e6, 8e6, CPU),
        _ev("void cub::DeviceRadixSortOnesweepKernel<int>", 4e6, 5e6, CUDA),
        _ev("encode_windows_kernel<long>", 4.5e6, 5.5e6, CUDA),
        _ev("rle_tiles<long>", 5.5e6, 6e6, CUDA),
        _ev("Memcpy DtoH (Device -> Pageable)", 6.5e6, 8e6, CUDA),
        _ev("aten::sort", 4e6, 5e6, CPU),
    ]
    return trace.reduce(events, {"read_sequences", "portbench.count", "pull_table"}, CUDA, CPU)


def test_reduce_busy_union_and_gaps():
    t = _trace()
    assert t.window_s == pytest.approx(10.0)
    assert t.busy_s == pytest.approx(2.0 + 1.5)  # 4-6 s and 6.5-8 s
    assert t.seconds(["RadixSort"]) == pytest.approx(1.0)
    assert t.gaps_by_span == pytest.approx(
        {"read_sequences": 4.0, "pull_table": 0.5, "outside any span": 2.0})
    b = t.breakdown()
    assert b["device_ops"][0] == ["Memcpy DtoH (Device -> Pageable)", pytest.approx(1.5)]
    assert b["idle_gaps"][0] == ["read_sequences", pytest.approx(4.0)]


def test_readers_over_a_window():
    w = Window()
    w.bases, w.windows, w.distinct, w.count_s = 2_000_000_000, 1_000_000_000, 100_000_000, 8.0
    w.spans = {"read_sequences": 4.0}
    w.k = 21
    w.trace = _trace()
    read = lambda n: spec.metric_reader(n)(w)  # noqa: E731
    assert read("read_parse_s_per_gbase") == pytest.approx(2.0)
    assert read("engine_s_per_gbase") == pytest.approx(2.0)
    assert read("sort_s_per_gbase") == pytest.approx(0.5)
    assert read("d2h_s_per_gbase") == pytest.approx(0.75)
    assert read("output_s_per_gbase") is None
    assert read("device_idle_pct") == pytest.approx(65.0)
    codec = roofline.codec_bytes(w.bases, w.windows) / roofline.HBM_BYTES_PER_S / 1.0
    assert read("codec_roofline_pct") == pytest.approx(100 * codec)
    rle = roofline.rle_bytes(w.windows, w.distinct) / roofline.HBM_BYTES_PER_S / 0.5
    assert read("rle_roofline_pct") == pytest.approx(100 * rle)
    w.output_s = 1.0
    assert read("output_s_per_gbase") == pytest.approx(0.5)
    w.trace = None
    assert all(read(n) is None for n in ("sort_s_per_gbase", "d2h_s_per_gbase",
                                         "codec_roofline_pct", "rle_roofline_pct",
                                         "device_idle_pct"))
