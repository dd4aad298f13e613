"""Port merges (krust_tpu_torch.ops.merge) against the JAX merge kernels.

K3 against merge_sorted_kv / _lv, K5 against merge_sorted.

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

from krust_tpu.ops.pallas_merge import merge_sorted as jax_merge_keys
from krust_tpu.ops.pallas_merge import merge_sorted_kv, merge_sorted_lv
from krust_tpu.ops.table import _merge_compact as jax_merge_compact
from krust_tpu_torch.ops.keys import parts_from_numpy, parts_to_numpy
from krust_tpu_torch.ops.merge import merge_sorted, merge_sorted_keys, merge_sorted_keys_plain
from krust_tpu_torch.ops.table import _merge_compact

SENT = 0xFFFFFFFF


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches():
    yield
    jax.clear_caches()


def _part(rng, codes, m):
    """A compacted part of length m: the sorted distinct ``codes``, then
    the sentinel tail with zero counts."""
    n_real = codes.size
    hi = np.full(m, SENT, np.uint32)
    lo = np.full(m, SENT, np.uint32)
    cnt = np.zeros(m, np.uint32)
    hi[:n_real] = (codes >> np.uint64(32)).astype(np.uint32)
    lo[:n_real] = (codes & np.uint64(SENT)).astype(np.uint32)
    cnt[:n_real] = rng.integers(1, 500, n_real)
    return hi, lo, cnt


def _parts(seed, k, ma, na, mb, nb, kind="shared"):
    """Two compacted parts of ``kind``: drawn from one shared pool (many
    keys in both), every key of b also in a (the main path's case, two
    epochs over one genome), or a's keys all below b's."""
    rng = np.random.default_rng(seed)
    bits = 2 * k
    pool = np.unique(rng.integers(0, 1 << bits, 3 * max(na, nb) + 10, dtype=np.uint64))
    pool = pool[pool < (1 << bits) - 1]  # the all-ones code is the sentinel

    def pick(keys, n):
        return np.sort(rng.choice(keys, min(n, keys.size), replace=False))

    if kind == "shared":
        a, b = pick(pool, na), pick(pool, nb)
    elif kind == "b_in_a":
        a = pick(pool, na)
        b = pick(a, nb)
    else:
        assert kind == "a_below_b"
        a, b = pick(pool[: pool.size // 2], na), pick(pool[pool.size // 2 :], nb)
    return _part(rng, a, ma), _part(rng, b, mb)


def _id(case):
    ma, na, mb, nb, kind = case
    return f"{ma}-{na}-{mb}-{nb}" + ("" if kind == "shared" else f"-{kind}")


# one pair of part lengths (one interpret-mode compile per key width),
# unequal; the real entries range from almost all to almost none; b's keys
# all in a, and a wholly below b
CASES = [(3000, 2500, 1700, 1600, "shared"), (3000, 1, 1700, 1700, "shared"),
         (3000, 5, 1700, 5, "shared"), (3000, 2500, 1700, 1600, "b_in_a"),
         (3000, 2500, 1700, 1600, "a_below_b")]
#: k = 32: codes with bit 63 set, at both ends of the biased int64 range
KS = [16, 31, 32]


def _jax_merge(k, ah, al, ac, bh, bl, bc):
    if k <= 16:
        e_l, e_c = merge_sorted_lv(*map(jnp.asarray, (al, ac, bl, bc)), interpret=True)
        return np.where(np.asarray(e_l) == SENT, SENT, 0), e_l, e_c
    return merge_sorted_kv(*map(jnp.asarray, (ah, al, ac, bh, bl, bc)), interpret=True)


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("case", CASES, ids=_id)
def test_merge_matches_pallas(k, case):
    ma, na, mb, nb, kind = case
    (ah, al, ac), (bh, bl, bc) = _parts(ma + mb + k, k, ma, na, mb, nb, kind)
    e_h, e_l, e_c = _jax_merge(k, ah, al, ac, bh, bl, bc)
    got = merge_sorted(*parts_from_numpy(ah, al, ac, k), *parts_from_numpy(bh, bl, bc, k))
    g_h, g_l, g_c = parts_to_numpy(*got, k)
    np.testing.assert_array_equal(g_l, np.asarray(e_l))
    np.testing.assert_array_equal(g_c, np.asarray(e_c))
    np.testing.assert_array_equal(g_h, np.asarray(e_h))


def _check_merge_compact(k, a_planes, b_planes):
    a = tuple(map(jnp.asarray, a_planes))
    b = tuple(map(jnp.asarray, b_planes))
    e_h, e_l, e_c, e_n = jax_merge_compact(a, b, True, one_key=k <= 16)
    keys, cnt, n_u = _merge_compact(parts_from_numpy(*a_planes, k), parts_from_numpy(*b_planes, k))
    assert int(n_u.item()) == int(e_n)
    g_h, g_l, g_c = parts_to_numpy(keys, cnt, k)
    np.testing.assert_array_equal(g_l, np.asarray(e_l))
    np.testing.assert_array_equal(g_c, np.asarray(e_c))
    np.testing.assert_array_equal(g_h, np.asarray(e_h))


@pytest.mark.parametrize("k", KS)
def test_merge_compact_matches_jax(k):
    """Merge + weighted re-compaction of two parts: the table step of a
    multi-epoch count."""
    _check_merge_compact(k, *_parts(99 + k, k, 3000, 2900, 1700, 1400))


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("kind", ["b_in_a", "a_below_b"])
def test_merge_compact_cases_match_jax(k, kind):
    """The same table step where every key of b is in a (each of b's
    counts adds to one of a's), and where a lies wholly below b."""
    _check_merge_compact(k, *_parts(7 + k, k, 3000, 2500, 1700, 1600, kind))


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



# --- K5: keys-only uint32 merge ---------------------------------------------


def _sorted_u32(rng, m, n_sent):
    """m sorted uint32 keys, half of them at or above 2^31, drawn from a
    small pool (ties inside and across arrays), n_sent sentinels last."""
    pool = np.concatenate([
        rng.integers(0, 1 << 31, 40, dtype=np.uint64),
        rng.integers(1 << 31, SENT, 40, dtype=np.uint64),
    ]).astype(np.uint32)
    keys = np.sort(rng.choice(pool, m))
    keys[m - n_sent :] = SENT
    return keys


@pytest.mark.parametrize("m", [0, 1, 127, 1000])
def test_merge_keys_matches_pallas(m):
    rng = np.random.default_rng(m)
    a = _sorted_u32(rng, m, m // 5)
    b = _sorted_u32(rng, m, m // 3)
    exp = np.asarray(jax_merge_keys(jnp.asarray(a), jnp.asarray(b), interpret=True))
    got = merge_sorted_keys(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.uint32 and got.shape == (2 * m,)
    np.testing.assert_array_equal(got.numpy(), exp)
    np.testing.assert_array_equal(
        merge_sorted_keys_plain(torch.from_numpy(a), torch.from_numpy(b)).numpy(), exp
    )


def test_merge_keys_unsigned_order():
    """Keys at or above 2^31 sort above those below (a signed compare
    would put them first)."""
    a = torch.tensor([5, 0x80000000, SENT], dtype=torch.uint32)
    b = torch.tensor([0x7FFFFFFF, 0x80000000, 0xFFFFFFF0], dtype=torch.uint32)
    got = merge_sorted_keys(a, b).to(torch.int64).tolist()
    assert got == [5, 0x7FFFFFFF, 0x80000000, 0x80000000, 0xFFFFFFF0, SENT]


def test_merge_keys_refuses_unequal_shapes():
    a = np.zeros(300, np.uint32)
    b = np.zeros(500, np.uint32)
    with pytest.raises(ValueError, match="equal shape"):
        jax_merge_keys(jnp.asarray(a), jnp.asarray(b), interpret=True)
    with pytest.raises(ValueError, match="equal shape"):
        merge_sorted_keys(torch.from_numpy(a), torch.from_numpy(b))
