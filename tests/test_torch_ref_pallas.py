"""krust_tpu's tests/test_pallas.py, run against the port through krust_tpu's
call forms (see tests/torch_reference_suite.py and
tests/torch_reference_forms.py)."""

from torch_reference_suite import load

STATED: dict[str, str] = {}
BESIDE: dict[str, str] = {}

globals().update(load("test_pallas", STATED))
