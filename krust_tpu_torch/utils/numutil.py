"""Shared integer sizing helpers (shape bucketing for stable jit caches)."""

from __future__ import annotations


def round_pow2(n: int, lo: int = 1) -> int:
    """Smallest power of two >= max(n, lo) ... times lo's power if lo > 1.

    With ``lo`` a power of two, returns the smallest ``lo * 2^j >= n``
    (and at least ``lo``).
    """
    p = lo
    while p < n:
        p *= 2
    return p


def round_up(n: int, m: int) -> int:
    """Smallest multiple of m >= n."""
    return -(-n // m) * m
