"""krust_tpu's tests/test_native.py, run against the port (see
tests/torch_reference_suite.py), and the port's counterparts of its
engine-dispatch tests: the port asks ``torch.cuda.is_available()`` where
krust_tpu probes JAX's backend."""

import pytest
import torch

from torch_reference_suite import load

_PROBE = ("krust_tpu's JAX backend probe (_jax_usable, _jax_backend, _JAX_USABLE_CACHE); "
          "the port asks torch.cuda.is_available() and has no probe")
_JAX_PLATFORMS = ("JAX_PLATFORMS is JAX's own: the port reads KRUST_PLATFORM alone (and "
                  "has no JAX probe to patch)")

STATED = {
    "TestEngineDispatch::test_cpu_backend_unforced_routes_native": _PROBE,
    "TestEngineDispatch::test_jax_platforms_env_counts_as_forced": _JAX_PLATFORMS,
    "TestEngineDispatch::test_cpu_platform_forced_keeps_batch": _PROBE,
    "TestEngineDispatch::test_accelerator_routes_batch": _PROBE,
    "TestEngineDispatch::test_hung_jax_probe_times_out_to_native": _PROBE,
    "TestEngineDispatch::test_no_jax_routes_native_then_numpy": _PROBE,
    "TestEngineDispatch::test_numpy_request_wins": _PROBE,
}

#: each STATED test -> the port's test of its counterpart behaviour
BESIDE = {
    "TestEngineDispatch::test_cpu_backend_unforced_routes_native":
        "TestPortEngineDispatch::test_no_cuda_unforced_routes_native",
    "TestEngineDispatch::test_jax_platforms_env_counts_as_forced":
        "TestPortEngineDispatch::test_jax_platforms_env_is_not_read",
    "TestEngineDispatch::test_cpu_platform_forced_keeps_batch":
        "TestPortEngineDispatch::test_cpu_platform_forced_keeps_batch_on_the_cpu",
    "TestEngineDispatch::test_accelerator_routes_batch":
        "TestPortEngineDispatch::test_cuda_routes_batch",
    "TestEngineDispatch::test_hung_jax_probe_times_out_to_native":
        "TestPortEngineDispatch::test_no_probe_no_cuda_routes_native",
    "TestEngineDispatch::test_no_jax_routes_native_then_numpy":
        "TestPortEngineDispatch::test_no_cuda_routes_native_then_numpy",
    "TestEngineDispatch::test_numpy_request_wins":
        "TestPortEngineDispatch::test_numpy_request_wins_over_cuda",
}

globals().update(load("test_native", STATED))


class TestPortEngineDispatch:
    """``select_engine`` routing of the port: the native host core without
    CUDA, unless ``KRUST_PLATFORM=cpu`` keeps the batch engine on the CPU."""

    @pytest.fixture(autouse=True)
    def _unforced(self, monkeypatch):
        monkeypatch.delenv("KRUST_PLATFORM", raising=False)
        monkeypatch.delenv("KRUST_ENGINE", raising=False)

    def test_no_cuda_unforced_routes_native(self, monkeypatch):
        from krust_tpu_torch.models import engines as eng

        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        assert isinstance(eng.select_engine(eng.EngineConfig()), eng.NativeEngine)

    def test_jax_platforms_env_is_not_read(self, monkeypatch):
        from krust_tpu_torch.models import engines as eng

        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        monkeypatch.setenv("JAX_PLATFORMS", "cpu")
        assert isinstance(eng.select_engine(eng.EngineConfig()), eng.NativeEngine)

    def test_cpu_platform_forced_keeps_batch_on_the_cpu(self, monkeypatch):
        from krust_tpu_torch.models import engines as eng

        monkeypatch.setenv("KRUST_PLATFORM", "cpu")
        for cuda in (False, True):
            monkeypatch.setattr(torch.cuda, "is_available", lambda cuda=cuda: cuda)
            engine = eng.select_engine(eng.EngineConfig())
            assert isinstance(engine, eng.BatchEngine)
            assert engine.device == torch.device("cpu")

    def test_cuda_routes_batch(self, monkeypatch):
        from krust_tpu_torch.models import engines as eng

        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        engine = eng.select_engine(eng.EngineConfig())
        assert isinstance(engine, eng.BatchEngine)
        assert engine.device == torch.device("cuda")

    def test_no_probe_no_cuda_routes_native(self, monkeypatch):
        import time

        from krust_tpu_torch.models import engines as eng

        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        assert not hasattr(eng, "_JAX_USABLE_CACHE")
        t0 = time.perf_counter()
        for _ in range(2):
            assert isinstance(eng.select_engine(eng.EngineConfig()), eng.NativeEngine)
        assert time.perf_counter() - t0 < 5.0

    def test_no_cuda_routes_native_then_numpy(self, monkeypatch):
        from krust_tpu_torch.models import engines as eng

        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        assert isinstance(eng.select_engine(eng.EngineConfig()), eng.NativeEngine)
        cfg = eng.EngineConfig(use_native_host=False)
        assert isinstance(eng.select_engine(cfg), eng.NumpyEngine)

    def test_numpy_request_wins_over_cuda(self, monkeypatch):
        from krust_tpu_torch.models import engines as eng

        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        cfg = eng.EngineConfig(use_numpy_backend=True)
        assert isinstance(eng.select_engine(cfg), eng.NumpyEngine)
