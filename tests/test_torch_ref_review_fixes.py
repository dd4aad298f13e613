"""krust_tpu's tests/test_review_fixes.py, run against the port (see
tests/torch_reference_suite.py), and the port's counterparts of its JAX
probe tests."""

import pytest
import torch

from torch_reference_suite import load

_PROBE = ("krust_tpu's JAX backend probe and its deadline (jax.devices, "
          "_JAX_USABLE_CACHE); the port asks torch.cuda.is_available() and has no probe")

STATED = {
    "TestJaxProbeDeadline::test_hanging_devices_probe_times_out": _PROBE,
    "TestJaxProbeDeadline::test_failing_devices_probe_falls_back": _PROBE,
    "TestEngineOverridePrecedence::test_forced_device_raises_on_dead_probe": _PROBE,
}

#: each STATED test -> the port's test of its counterpart behaviour
BESIDE = {
    "TestJaxProbeDeadline::test_hanging_devices_probe_times_out":
        "TestPortNoCuda::test_routes_native_at_once",
    "TestJaxProbeDeadline::test_failing_devices_probe_falls_back":
        "TestPortNoCuda::test_routes_native",
    "TestEngineOverridePrecedence::test_forced_device_raises_on_dead_probe":
        "TestPortNoCuda::test_forced_device_raises",
}

globals().update(load("test_review_fixes", STATED))


class TestPortNoCuda:
    """Without CUDA (and without ``KRUST_PLATFORM=cpu``) the port routes to
    the native host core at once, and a forced device raises."""

    @pytest.fixture(autouse=True)
    def _no_cuda(self, monkeypatch):
        monkeypatch.delenv("KRUST_PLATFORM", raising=False)
        monkeypatch.delenv("KRUST_ENGINE", raising=False)
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def test_routes_native_at_once(self):
        import time

        from krust_tpu_torch.models import engines as eng

        t0 = time.monotonic()
        for _ in range(2):
            assert isinstance(eng.select_engine(eng.EngineConfig()), eng.NativeEngine)
        assert time.monotonic() - t0 < 5.0

    def test_routes_native(self):
        from krust_tpu_torch.models import engines as eng

        assert isinstance(eng.select_engine(eng.EngineConfig()), eng.NativeEngine)

    def test_forced_device_raises(self, monkeypatch):
        from krust_tpu_torch.models import engines as eng

        monkeypatch.setenv("KRUST_ENGINE", "device")
        with pytest.raises(RuntimeError, match="KRUST_ENGINE=device"):
            eng.select_engine(eng.EngineConfig())
