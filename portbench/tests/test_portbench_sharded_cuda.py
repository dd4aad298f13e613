"""The four-card cell ``readset_k21_4gpu`` on a host of four cards, at a
sixteenth of its size: untraced and traced runs, and the control. Marked
``cuda``; each test skips without 4 CUDA devices (decided inside the test).

    python3 -m pytest portbench/tests/test_portbench_sharded_cuda.py -q
"""

import pytest
import torch

from portbench import run, spec

from .helpers import ROOT

pytestmark = pytest.mark.cuda

CELL = "readset_k21_4gpu"
#: a sixteenth of the cell: the same shapes, seconds to run
SMALL = {"total_bases": 64_000_000, "genome_bases": 2_000_000}


def _cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs 4 CUDA devices")
    return torch.device("cuda")


def _small():
    cell = spec.Cell(spec.benchmark(ROOT), CELL)
    cell.config = dict(cell.config, **SMALL)
    return cell


@pytest.mark.parametrize("traced", [False, True])
def test_the_cell_on_four_cards(traced):
    dev = _cards()
    cell = _small()
    out = run.run_cell(cell, 2**31 + 109, 3.0, traced, dev)
    assert out["correct"] and out["failed"] == 0
    assert out["device"]["platform"] == "gpu" and out["device"]["count"] == 4
    want = {m["name"] for m in (cell.per_layer if traced else cell.end_to_end)}
    assert set(out["metrics"]) == want
    # the flat route, and K3 in the exchange and the gather
    assert out["route"]["encode_windows"] > 0 and out["route"]["merge_sorted"] > 0
    if traced:
        assert 0 < out["metrics"]["merge_roofline_pct"]["value"] <= 100
        assert all(out["metrics"][m]["value"] > 0 for m in want)


def test_the_control_fails_on_four_cards():
    from portbench import control

    got = control.readings(_small(), 2**31 + 113, _cards())
    assert got["program"] == {"entries_off": 0}
    assert got["control"]["entries_off"] > 0
