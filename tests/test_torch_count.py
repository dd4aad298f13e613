"""The port's sort-based counting functions against ``krust_tpu.ops.count``.

The same numpy keys and weights, made from a seed, go through each of the
five JAX functions (on the CPU) and its counterpart in
``krust_tpu_torch.ops.count`` (CPU tensors, so the RLE kernel's plain
version runs underneath). What must agree, exactly (integers: tolerance
0): each function's table, the entries with count > 0 in key order, and
``n_unique``. Padding differs by design (zero-scrubbed keys there, sentinel
keys here) and is not compared.
"""

import jax
import numpy as np
import pytest
import torch

from krust_tpu.ops import count as jax_count
from krust_tpu_torch.ops import count as port_count
from krust_tpu_torch.ops.keys import parts_from_numpy, parts_to_numpy, sentinel

KS = [5, 16, 17, 31, 32]
CASES = ["random", "zero_padding", "all_invalid", "empty", "one_key", "zero_sum_run"]
SENT = np.uint32(0xFFFFFFFF)


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches():
    yield
    jax.clear_caches()


def _codes(rng, n, k, distinct=40):
    """n draws from a small pool of k-mer codes that reaches the top of the
    code space (bit 63 at k = 32, bit 31 at k = 16), never the all-ones
    code: (hi, lo) uint32 planes."""
    top = (1 << (2 * k)) - 1
    pool = np.concatenate([
        rng.integers(0, min(top, 1 << 62), distinct - 2, dtype=np.uint64),
        np.array([0, top - 1], np.uint64),
    ])
    codes = pool[rng.integers(0, distinct, n)]
    return (codes >> np.uint64(32)).astype(np.uint32), codes.astype(np.uint32)


def _case(case, k, seed):
    """(hi, lo, weight, valid) of a case: weights 0 are padding for the
    merge_runs functions, ``valid`` the mask for the others."""
    rng = np.random.default_rng(seed)
    n = {"empty": 0, "one_key": 1}.get(case, 700)
    hi, lo = _codes(rng, n, k)
    weight = rng.integers(1, 60, n).astype(np.uint32)
    valid = np.ones(n, bool)
    if case == "zero_padding":  # zero-weight entries under real and junk keys
        weight[rng.random(n) < 0.3] = 0
        valid = rng.random(n) < 0.8
    elif case == "all_invalid":
        weight[:] = 0
        valid[:] = False
    elif case == "zero_sum_run":  # every entry of some keys weighs 0
        dead = (lo % 3) == 0
        weight[dead] = 0
        valid = ~dead
    return hi, lo, weight, valid


def _table(hi, lo, cnt):
    """Entries with count > 0 as (codes, counts), in their order."""
    hi, lo, cnt = (np.asarray(a, np.uint32).reshape(-1) for a in (hi, lo, cnt))
    live = cnt > 0
    codes = hi[live].astype(np.uint64) << np.uint64(32) | lo[live].astype(np.uint64)
    return codes, cnt[live]


def _assert_same_table(port_out, jax_out, k):
    """The port's (keys, cnt[, n]) against krust_tpu's (hi, lo, cnt[, n])."""
    p_hi, p_lo, p_cnt = parts_to_numpy(port_out[0], port_out[1], k, zero_is_padding=True)
    got, exp = _table(p_hi, p_lo, p_cnt), _table(*jax_out[:3])
    np.testing.assert_array_equal(got[0], exp[0])
    np.testing.assert_array_equal(got[1], exp[1])
    assert np.all(np.diff(got[0].astype(object)) > 0)  # key order, distinct
    if len(port_out) == 3:
        assert int(port_out[2].item()) == int(jax_out[3])
        n = int(port_out[2].item())  # compacted to the front, padding after
        assert torch.all(port_out[0][n:] == sentinel(port_out[0].dtype))
        assert torch.all(port_out[1][n:] == 0)
    assert port_out[0].numel() == port_out[1].numel()


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("k", KS)
def test_merge_weighted_matches_jax(k, case):
    hi, lo, weight, valid = _case(case, k, 10 * k)
    keys, cnt = parts_from_numpy(hi, lo, weight, k)
    got = port_count.merge_weighted(keys, cnt, torch.from_numpy(valid))
    exp = jax_count.merge_weighted(hi, lo, weight, valid)
    _assert_same_table(got, exp, k)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("k", KS)
def test_count_unique_matches_jax(k, case):
    hi, lo, weight, valid = _case(case, k, 10 * k + 1)
    keys, _ = parts_from_numpy(hi, lo, weight, k)
    got = port_count.count_unique(keys, torch.from_numpy(valid))
    exp = jax_count.count_unique(hi, lo, valid)
    _assert_same_table(got, exp, k)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("k", KS)
def test_count_runs_matches_jax(k, case):
    hi, lo, weight, valid = _case(case, k, 10 * k + 2)
    keys, _ = parts_from_numpy(hi, lo, weight, k)
    got = port_count.count_runs(keys, torch.from_numpy(valid))
    exp = jax_count.count_runs(hi, lo, valid, k)
    _assert_same_table(got, exp, k)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("k", KS)
def test_merge_runs_matches_jax(k, case):
    """Zero-weight entries are padding whatever their key: a raw part
    crosses with ``zero_is_padding`` and, to show the port drops them
    itself, as it is."""
    hi, lo, weight, _ = _case(case, k, 10 * k + 3)
    exp = jax_count.merge_runs(hi, lo, weight, k)
    for zero_is_padding in (True, False):
        keys, cnt = parts_from_numpy(hi, lo, weight, k, zero_is_padding=zero_is_padding)
        _assert_same_table(port_count.merge_runs(keys, cnt), exp, k)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("k", KS)
def test_merge_runs_presorted_matches_jax(k, case):
    """A key-sorted stream with the sentinel pair at the back; zero weights
    inside live runs, and runs whose weights are all zero."""
    hi, lo, weight, _ = _case(case, k, 10 * k + 4)
    n = hi.shape[0]
    order = np.lexsort((lo, hi))
    hi, lo, weight = hi[order], lo[order], weight[order]
    if case == "zero_padding":  # a few zero weights inside live runs stay
        weight[::5] = np.maximum(weight[::5], 1)
    tail = n // 8
    if tail:
        hi[n - tail:], lo[n - tail:] = SENT, SENT
        weight[n - tail:] = np.arange(tail) % 2  # sentinels carry any weight
    keys, cnt = parts_from_numpy(hi, lo, weight, k)
    got = port_count.merge_runs_presorted(keys, cnt)
    exp = list(jax_count.merge_runs_presorted(hi, lo, weight))
    # krust_tpu's padding keeps the sentinel pair with count 0
    _assert_same_table(got, exp, k)


def test_all_t_32mers_count_as_all_a():
    """At k = 32 ``krust_tpu`` counts the all-ones code as a real key and the
    port takes it for the sentinel. No input produces it: a stream of T's
    canonicalizes to all-A's through both packages."""
    from krust_tpu.io.reader import ParsedStreams as JaxStreams
    from krust_tpu.models.engines import BatchEngine as JaxEngine
    from krust_tpu.utils.config import EngineConfig as JaxConfig
    from krust_tpu_torch.io.reader import ParsedStreams
    from krust_tpu_torch.models.engines import BatchEngine
    from krust_tpu_torch.utils.config import EngineConfig

    codes = np.full(500, 3, np.uint8)
    for epoch_sort in (True, False):
        exp = JaxEngine(
            JaxConfig(block_windows=256, batch_rows=8, use_epoch_sort=epoch_sort)
        ).count(JaxStreams(codes, None, 1, 500), 32)
        got = BatchEngine(
            EngineConfig(block_windows=256, batch_rows=8, device="cpu",
                         use_epoch_sort=epoch_sort)
        ).count(ParsedStreams(codes, None, 1, 500), 32)
        assert got.codes.tolist() == exp.codes.tolist() == [0]
        assert got.counts.tolist() == exp.counts.tolist() == [500 - 31]


def test_all_ones_key_is_the_sentinel_at_k32():
    """The stated difference: the all-ones code with a weight is a key to
    ``krust_tpu.merge_runs`` at k = 32 and padding to the port."""
    hi = np.array([0, 0xFFFFFFFF, 0xFFFFFFFF], np.uint32)
    lo = np.array([7, 0xFFFFFFFF, 0xFFFFFFFE], np.uint32)
    weight = np.array([2, 3, 4], np.uint32)
    assert int(jax_count.merge_runs(hi, lo, weight, 32)[3]) == 3
    keys, cnt = parts_from_numpy(hi, lo, weight, 32)
    u_keys, u_cnt, n = port_count.merge_runs(keys, cnt)
    assert int(n.item()) == 2 and u_cnt.tolist() == [2, 4, 0]
