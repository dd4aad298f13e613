"""krust_tpu's tests/test_tracing.py, run against the port (see
tests/torch_reference_suite.py)."""

from torch_reference_suite import load

STATED: dict[str, str] = {}
BESIDE: dict[str, str] = {}

globals().update(load("test_tracing", STATED))
