"""krust_tpu's tests/test_epoch_table.py, run against the port through
krust_tpu's call forms (see tests/torch_reference_suite.py and
tests/torch_reference_forms.py)."""

import numpy as np

from krust_tpu_torch.io.reader import ParsedStreams
from krust_tpu_torch.models.engines import BatchEngine as PortBatchEngine
from krust_tpu_torch.models.engines import NumpyEngine as PortNumpyEngine
from krust_tpu_torch.models.engines import _Lifetimes
from krust_tpu_torch.ops import table as port_table
from krust_tpu_torch.utils.config import EngineConfig as PortEngineConfig
from krust_tpu_torch.utils.config import default_device
from torch_reference_suite import load

STATED = {
    "TestAdaptiveAndScaledLimits::test_env_override_pins_limits":
        "_pending_limit: krust_tpu's EpochTable inherits it from DeviceTable "
        "(krust_tpu/ops/table.py:650); the port's EpochTable is no subclass and its "
        "DeviceTable holds the limit",
    "TestAdaptiveAndScaledLimits::test_hbm_scaling":
        "_HBM_CACHE (krust_tpu/ops/table.py:76), the TPU's cached HBM size; the port "
        "scales by each device's memory (ops/table._device_mem_bytes)",
    "TestAdaptiveAndScaledLimits::test_adaptive_epoch_shrinks_on_duplication":
        "BatchEngine._make_table returns (mode, table) in krust_tpu "
        "(krust_tpu/models/engines.py:554); the port's returns the table",
    "TestAdaptiveAndScaledLimits::test_adaptive_epoch_keeps_large_on_low_duplication":
        "BatchEngine._make_table returns (mode, table) in krust_tpu "
        "(krust_tpu/models/engines.py:554); the port's returns the table",
}

#: each STATED test -> the port's test of its counterpart behaviour
BESIDE = {
    "TestAdaptiveAndScaledLimits::test_env_override_pins_limits":
        "TestPortAdaptiveAndScaledLimits::test_env_override_pins_limits",
    "TestAdaptiveAndScaledLimits::test_hbm_scaling":
        "TestPortAdaptiveAndScaledLimits::test_memory_scaling",
    "TestAdaptiveAndScaledLimits::test_adaptive_epoch_shrinks_on_duplication":
        "TestPortAdaptiveAndScaledLimits::test_adaptive_epoch_shrinks_on_duplication",
    "TestAdaptiveAndScaledLimits::test_adaptive_epoch_keeps_large_on_low_duplication":
        "TestPortAdaptiveAndScaledLimits::test_adaptive_epoch_keeps_large_on_low_duplication",
}

globals().update(load("test_epoch_table", STATED))


def _pin_limits(monkeypatch, epoch_entries):
    """The epoch limit as set, unscaled by the device's memory (a card's
    scaling would lift a small limit to its floor of 2^20 entries)."""
    monkeypatch.delenv("KRUST_EPOCH_ENTRIES", raising=False)
    monkeypatch.setattr(port_table, "EPOCH_ENTRY_LIMIT", epoch_entries)
    monkeypatch.setattr(port_table, "_device_mem_bytes", lambda d: None)
    monkeypatch.setattr(port_table.EpochTable, "ADAPT_MIN", 64)


def _port_feed(codes, k):
    """The port's engine's epoch table fed one stream, and its lifetimes."""
    streams = ParsedStreams(codes, None, 1, codes.shape[0])
    engine = PortBatchEngine(PortEngineConfig(block_windows=256, batch_rows=8))
    lifetimes = _Lifetimes(engine._make_table(k), False)
    engine._feed_streams(streams, k, None, lifetimes, lambda w: None)
    return streams, lifetimes.table, lifetimes


class TestPortAdaptiveAndScaledLimits:
    """The port's memory-scaled entry limits and duplication-adaptive epoch."""

    def test_env_override_pins_limits(self, monkeypatch):
        monkeypatch.setenv("KRUST_EPOCH_ENTRIES", "12345")
        monkeypatch.setenv("KRUST_PENDING_ENTRIES", "6789")
        assert port_table.epoch_entry_limit() == 12345
        t = port_table.EpochTable(k=11)
        assert t._epoch_limit == 12345 and t._adaptive is False
        assert port_table.DeviceTable(k=11)._pending_limit == 6789

    def test_memory_scaling(self, monkeypatch):
        monkeypatch.delenv("KRUST_EPOCH_ENTRIES", raising=False)
        dev = default_device()
        ref = port_table._REFERENCE_MEM
        monkeypatch.setattr(port_table, "_device_mem_bytes", lambda d: ref // 2)
        assert port_table.epoch_entry_limit(dev) == port_table.EPOCH_ENTRY_LIMIT // 2
        monkeypatch.setattr(port_table, "_device_mem_bytes", lambda d: 1 << 20)
        assert port_table.epoch_entry_limit(dev) == 1 << 20  # the floor
        monkeypatch.setattr(port_table, "_device_mem_bytes", lambda d: None)
        assert port_table.epoch_entry_limit(dev) == port_table.EPOCH_ENTRY_LIMIT

    def test_adaptive_epoch_shrinks_on_duplication(self, monkeypatch):
        _pin_limits(monkeypatch, 4096)
        motif = np.random.default_rng(55).integers(0, 4, 40, dtype=np.uint8)
        streams, table, lifetimes = _port_feed(np.concatenate([motif] * 600), 9)
        assert table._adaptive is False and table._epoch_limit < 4096
        got = lifetimes.result(9)
        exp = PortNumpyEngine(PortEngineConfig()).count(streams, 9)
        np.testing.assert_array_equal(got.codes, exp.codes)
        np.testing.assert_array_equal(got.counts, exp.counts)

    def test_adaptive_epoch_keeps_large_on_low_duplication(self, monkeypatch):
        _pin_limits(monkeypatch, 2048)
        codes = np.random.default_rng(56).integers(0, 4, 12_000, dtype=np.uint8)
        _, table, _ = _port_feed(codes, 15)
        table.finalize()
        assert table._epoch_limit == 2048
