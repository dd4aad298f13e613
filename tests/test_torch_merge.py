"""Port merge (krust_tpu_torch.ops.merge) against merge_sorted_kv / _lv.

Compacted parts (distinct sorted keys, counts, sentinel tail) are made with
numpy, fed to the JAX merge kernels in interpret mode (at the small merge
chunk the harness sets) and, through ``parts_from_numpy``, to the port.
Unequal lengths and keys present in both parts; the merged planes and the
re-compacted table (merge + weighted RLE) must be equal (tolerance 0).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from krust_tpu.ops.pallas_merge import merge_sorted_kv, merge_sorted_lv
from krust_tpu.ops.table import _merge_compact as jax_merge_compact
from krust_tpu_torch.ops.keys import parts_from_numpy, parts_to_numpy
from krust_tpu_torch.ops.merge import merge_sorted
from krust_tpu_torch.ops.table import _merge_compact

SENT = 0xFFFFFFFF


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches():
    yield
    jax.clear_caches()


def _part(rng, pool, m, n_real):
    """A compacted part of length m: n_real distinct keys from ``pool``,
    then the sentinel tail with zero counts."""
    codes = np.sort(rng.choice(pool, n_real, replace=False))
    hi = np.full(m, SENT, np.uint32)
    lo = np.full(m, SENT, np.uint32)
    cnt = np.zeros(m, np.uint32)
    hi[:n_real] = (codes >> np.uint64(32)).astype(np.uint32)
    lo[:n_real] = (codes & np.uint64(SENT)).astype(np.uint32)
    cnt[:n_real] = rng.integers(1, 500, n_real)
    return hi, lo, cnt


def _parts(seed, k, ma, na, mb, nb):
    rng = np.random.default_rng(seed)
    bits = 2 * k
    # a shared pool: many keys land in both parts
    pool = np.unique(rng.integers(0, 1 << bits, 3 * max(na, nb) + 10, dtype=np.uint64))
    if k <= 16:
        pool = pool[pool < SENT]
    return _part(rng, pool, ma, min(na, pool.size)), _part(rng, pool, mb, min(nb, pool.size))


# one pair of part lengths (one interpret-mode compile per k), unequal;
# the real entries range from almost all to almost none
CASES = [(3000, 2500, 1700, 1600), (3000, 1, 1700, 1700), (3000, 5, 1700, 5)]


@pytest.mark.parametrize("k", [16, 31])
@pytest.mark.parametrize("ma,na,mb,nb", CASES)
def test_merge_matches_pallas(k, ma, na, mb, nb):
    (ah, al, ac), (bh, bl, bc) = _parts(ma + mb + k, k, ma, na, mb, nb)
    if k <= 16:
        e_l, e_c = merge_sorted_lv(*map(jnp.asarray, (al, ac, bl, bc)), interpret=True)
        e_h = np.where(np.asarray(e_l) == SENT, SENT, 0)
    else:
        e_h, e_l, e_c = merge_sorted_kv(
            *map(jnp.asarray, (ah, al, ac, bh, bl, bc)), interpret=True
        )
    got = merge_sorted(*parts_from_numpy(ah, al, ac, k), *parts_from_numpy(bh, bl, bc, k))
    g_h, g_l, g_c = parts_to_numpy(*got, k)
    np.testing.assert_array_equal(g_l, np.asarray(e_l))
    np.testing.assert_array_equal(g_c, np.asarray(e_c))
    np.testing.assert_array_equal(g_h, np.asarray(e_h))


@pytest.mark.parametrize("k", [16, 31])
def test_merge_compact_matches_jax(k):
    """Merge + weighted re-compaction of two parts: the table step of a
    multi-epoch count."""
    (ah, al, ac), (bh, bl, bc) = _parts(99 + k, k, 3000, 2900, 1700, 1400)
    a = tuple(map(jnp.asarray, (ah, al, ac)))
    b = tuple(map(jnp.asarray, (bh, bl, bc)))
    e_h, e_l, e_c, e_n = jax_merge_compact(a, b, True, one_key=k <= 16)
    keys, cnt, n_u = _merge_compact(
        parts_from_numpy(ah, al, ac, k), parts_from_numpy(bh, bl, bc, k)
    )
    assert int(n_u.item()) == int(e_n)
    g_h, g_l, g_c = parts_to_numpy(keys, cnt, k)
    np.testing.assert_array_equal(g_l, np.asarray(e_l))
    np.testing.assert_array_equal(g_c, np.asarray(e_c))
    np.testing.assert_array_equal(g_h, np.asarray(e_h))


def test_empty_side():
    keys = torch.tensor([1, 5, 9], dtype=torch.int64)
    cnt = torch.tensor([1, 2, 3], dtype=torch.int32)
    empty_k, empty_c = keys[:0], cnt[:0]
    got_k, got_c = merge_sorted(keys, cnt, empty_k, empty_c)
    assert torch.equal(got_k, keys) and torch.equal(got_c, cnt)
    got_k, got_c = merge_sorted(empty_k, empty_c, keys, cnt)
    assert torch.equal(got_k, keys) and torch.equal(got_c, cnt)


def test_ties_keep_a_first():
    a = torch.tensor([3, 3, 7], dtype=torch.int32)
    b = torch.tensor([3, 7, 8], dtype=torch.int32)
    ac = torch.tensor([1, 2, 3], dtype=torch.int32)
    bc = torch.tensor([10, 20, 30], dtype=torch.int32)
    k, c = merge_sorted(a, ac, b, bc)
    assert k.tolist() == [3, 3, 3, 7, 7, 8]
    assert c.tolist() == [1, 2, 10, 3, 20, 30]

