"""The port's sort-based counting functions against ``krust_tpu.ops.count``.

The same numpy keys and weights, made from a seed, go through each of the
five JAX functions (on the CPU) and its counterpart in
``krust_tpu_torch.ops.count`` (CPU tensors, so the RLE kernel's plain
version runs underneath). What must agree, exactly (integers: tolerance
0): each function's table, the entries with count > 0 in key order, and
``n_unique``. Padding differs by design (zero-scrubbed keys there, sentinel
keys here) and is not compared. The all-ones code, the port's sentinel
key, is a key to both packages where it is valid: merge_weighted and
count_unique at every width, count_runs and merge_runs at k = 32.
"""

import jax
import numpy as np
import pytest
import torch

from krust_tpu.ops import count as jax_count
from krust_tpu_torch.ops import count as port_count
from krust_tpu_torch.ops.keys import keys_to_codes, parts_from_numpy, sentinel

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
    """The port's (keys, cnt[, n]) against krust_tpu's (hi, lo, cnt[, n]);
    a port entry under the sentinel key with a count is the all-ones code."""
    codes = keys_to_codes(port_out[0].numpy(), k)
    cnt = port_out[1].numpy().view(np.uint32)
    got, exp = (codes[cnt > 0], cnt[cnt > 0]), _table(*jax_out[:3])
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
    """At k = 32 both packages count the all-ones code as a real key where
    it is valid, yet no input produces it: a stream of T's canonicalizes to
    all-A's through both packages."""
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
    """The port's sentinel key is the all-ones code, which ``krust_tpu``
    counts at k = 32 where it is valid: merge_weighted, count_unique,
    count_runs and merge_runs (weight > 0 for valid) take it for a key in
    both packages, with weights 0 and above 0, and last in key order."""
    ones = np.uint32(0xFFFFFFFF)
    hi = np.array([0, ones, ones, ones, 5, ones, 0x80000000], np.uint32)
    lo = np.array([7, ones, 0xFFFFFFFE, ones, 9, ones, 3], np.uint32)
    valid = np.array([True, True, True, False, True, True, True])
    for all_ones_weight in (0, 3):
        weight = np.array([2, all_ones_weight, 4, 6, 1, all_ones_weight, 8], np.uint32)
        keys, cnt = parts_from_numpy(hi, lo, weight, 32)
        v = torch.from_numpy(valid)
        for got, exp in (
            (port_count.merge_weighted(keys, cnt, v),
             jax_count.merge_weighted(hi, lo, weight, valid)),
            (port_count.count_unique(keys, v), jax_count.count_unique(hi, lo, valid)),
            (port_count.count_runs(keys, v), jax_count.count_runs(hi, lo, valid, 32)),
            (port_count.merge_runs(keys, cnt), jax_count.merge_runs(hi, lo, weight, 32)),
        ):
            _assert_same_table(got, exp, 32)
        u_keys, u_cnt, n = port_count.merge_weighted(keys, cnt, v)
        assert int(n.item()) == 5 and u_keys[4] == sentinel(torch.int64)
        assert int(u_cnt[4]) == 2 * all_ones_weight  # a zero sum keeps its slot
        # merge_runs reads no valid: the third all-ones entry's weight 6 counts
        assert int(port_count.merge_runs(keys, cnt)[1][4]) == 6 + 2 * all_ones_weight


#: (function, k, weight of the all-ones entries): the weighted functions
#: with zero and positive weights there, the unweighted ones once, at both
#: key widths whose sentinel is a code (k = 16: int32, k = 32: int64)
ALL_ONES_CASES = [
    *[(fn, k, w) for fn in ("merge_weighted", "merge_runs") for k in (16, 32)
      for w in ("zero", "positive")],
    *[(fn, k, None) for fn in ("count_unique", "count_runs") for k in (16, 32)],
]


@pytest.mark.parametrize("fn,k,weights", ALL_ONES_CASES,
                         ids=[f"{f}-k{k}-{w or 'unit'}" for f, k, w in ALL_ONES_CASES])
def test_all_ones_code_matches_jax(fn, k, weights):
    """Random keys with the all-ones code mixed in, some of it invalid:
    every function's table and ``n_unique`` equal ``krust_tpu``'s (at k =
    16 ``krust_tpu``'s count_runs and merge_runs drop it, as the port's
    do)."""
    rng = np.random.default_rng(k + len(fn))
    hi, lo = _codes(rng, 500, k)
    ones = rng.random(500) < 0.1
    hi[ones], lo[ones] = (0xFFFFFFFF if k == 32 else 0), 0xFFFFFFFF
    weight = rng.integers(1, 60, 500).astype(np.uint32)
    if weights == "zero":
        weight[ones] = 0
    valid = rng.random(500) < 0.8
    keys, cnt = parts_from_numpy(hi, lo, weight, k)
    v = torch.from_numpy(valid)
    if fn == "merge_weighted":
        got, exp = (port_count.merge_weighted(keys, cnt, v),
                    jax_count.merge_weighted(hi, lo, weight, valid))
    elif fn == "merge_runs":
        got, exp = port_count.merge_runs(keys, cnt), jax_count.merge_runs(hi, lo, weight, k)
    elif fn == "count_unique":
        got, exp = port_count.count_unique(keys, v), jax_count.count_unique(hi, lo, valid)
    else:
        got, exp = port_count.count_runs(keys, v), jax_count.count_runs(hi, lo, valid, k)
    _assert_same_table(got, exp, k)
