"""Randomized fuzz harness of krust_tpu_torch (reference: fuzz/fuzz_targets/*.rs).

``fuzz/fuzz_targets.py`` on the port: the same targets and the same
seeded loop, against ``krust_tpu_torch``'s k-mer module.

Three targets mirroring the reference's libfuzzer suite, driven by a seeded
byte-mutating loop (no external fuzzer dependency):

- ``from_sub``: arbitrary bytes either validate (uppercased ACGT out) or
  raise InvalidBaseError with the correct position and byte.
- ``pack_unpack``: ACGT/acgt inputs round-trip through pack/unpack.
- ``canonical``: idempotence, RC-equivalence, lexicographic minimality.

Usage: python fuzz/fuzz_targets_torch.py [iterations]
"""

from __future__ import annotations

import os
import random
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from krust_tpu_torch import Kmer, canonical_packed, pack, unpack_to_string
from krust_tpu_torch.errors import InvalidBaseError

_COMP = {"A": "T", "C": "G", "G": "C", "T": "A"}


def fuzz_from_sub(data: bytes) -> None:
    try:
        kmer = Kmer.from_sub(data)
    except InvalidBaseError as e:
        assert 0 <= e.position < len(data)
        assert data[e.position] == e.base
        assert chr(data[e.position]).upper() not in "ACGT" or not chr(
            data[e.position]
        ).isascii()
        return
    assert kmer.bytes == data.upper()
    assert set(kmer.bytes) <= set(b"ACGT")


def fuzz_pack_unpack(rng: random.Random) -> None:
    k = rng.randint(1, 32)
    s = "".join(rng.choice("ACGTacgt") for _ in range(k))
    assert unpack_to_string(pack(s), k) == s.upper()


def fuzz_canonical(rng: random.Random) -> None:
    k = rng.randint(1, 32)
    s = "".join(rng.choice("ACGT") for _ in range(k))
    bits = pack(s)
    canon, is_rc = canonical_packed(bits, k)
    # idempotence
    again, again_rc = canonical_packed(canon, k)
    assert again == canon and not again_rc
    # RC-equivalence
    rc = "".join(_COMP[c] for c in reversed(s))
    canon_rc, _ = canonical_packed(pack(rc), k)
    assert canon_rc == canon
    # minimality
    assert canon <= bits and canon <= pack(rc)


def main(iterations: int = 20000) -> None:
    rng = random.Random(12345)
    for i in range(iterations):
        n = rng.randint(0, 64)
        data = bytes(rng.getrandbits(8) for _ in range(n))
        fuzz_from_sub(data)
        fuzz_pack_unpack(rng)
        fuzz_canonical(rng)
        if (i + 1) % 5000 == 0:
            print(f"{i + 1} iterations OK")
    print("fuzz targets passed")


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 20000)
