"""Coverage-guided fuzzer of krust_tpu_torch (the libfuzzer analog;
reference: fuzz/fuzz_targets/).

``fuzz/coverage_fuzz.py`` on the port: the same targets, corpus seeds and
mutation loop, with edge coverage of the ``krust_tpu_torch`` modules.

The reference fuzzes with libfuzzer's edge-coverage-guided corpus evolution
(reference: fuzz/fuzz_targets/fuzz_kmer_from_sub.rs, fuzz_pack_unpack.rs,
fuzz_canonical.rs). This harness reproduces that search power in pure
Python 3.12: ``sys.monitoring`` BRANCH events give per-run edge coverage of
the krust_tpu_torch modules, a corpus keeps every input that reached new edges,
and mutations (byte flips, arithmetic, inserts/deletes, splices, interesting
values) evolve it — the classic AFL/libfuzzer loop. Inputs are raw byte
buffers; each target derives its structure from them exactly as the
libfuzzer targets do from ``&[u8]``.

Assertion failures are BUGS: the failing input is written to
``fuzz/crashes/`` and the process exits 1.

Usage: python fuzz/coverage_fuzz_torch.py [iterations] [target]
       (target: from_sub | pack_unpack | canonical | all; default all)
"""

from __future__ import annotations

import os
import random
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from krust_tpu_torch import Kmer, canonical_packed, pack, unpack_to_string
from krust_tpu_torch.errors import InvalidBaseError

_COMP = {"A": "T", "C": "G", "G": "C", "T": "A"}
_TOOL_ID = 5  # sys.monitoring tool slot (0-5 free for applications)

_INTERESTING = [0, 1, 4, 0x3E, 0x40, ord("A"), ord("C"), ord("G"), ord("T"),
                ord("a"), ord("t"), ord("N"), ord("n"), 0x7F, 0x80, 0xFF]


class EdgeCoverage:
    """Edge coverage of krust_tpu_torch code via sys.monitoring BRANCH+JUMP
    events."""

    def __init__(self):
        self.seen: set[tuple] = set()
        self.current: set[tuple] = set()
        mon = sys.monitoring
        mon.use_tool_id(_TOOL_ID, "krust-fuzz")
        mon.register_callback(_TOOL_ID, mon.events.BRANCH, self._on_branch)
        mon.register_callback(_TOOL_ID, mon.events.JUMP, self._on_branch)
        mon.set_events(_TOOL_ID, mon.events.BRANCH | mon.events.JUMP)

    def _on_branch(self, code, src, dst):
        if "krust_tpu_torch" in code.co_filename:
            self.current.add((code.co_qualname, src, dst))

    def run(self, fn, *args) -> int:
        """Run fn, return the number of NEW edges it covered."""
        self.current = set()
        fn(*args)
        new = self.current - self.seen
        self.seen |= new
        return len(new)


# --- targets: byte-buffer driven, like the libfuzzer ones -------------------


def target_from_sub(data: bytes) -> None:
    """Graceful accept/reject; error position & byte correctness
    (reference: fuzz/fuzz_targets/fuzz_kmer_from_sub.rs)."""
    try:
        kmer = Kmer.from_sub(data)
    except InvalidBaseError as e:
        assert 0 <= e.position < len(data)
        assert data[e.position] == e.base
        assert chr(data[e.position]).upper() not in "ACGT"
        return
    assert kmer.bytes == data.upper()
    assert set(kmer.bytes) <= set(b"ACGT")


def _derive_dna(data: bytes, alphabet: str) -> str:
    """First byte -> k in 1..=32, remaining bytes -> letters (libfuzzer style)."""
    k = (data[0] % 32) + 1 if data else 1
    return "".join(alphabet[b % len(alphabet)] for b in data[1 : 1 + k]).ljust(
        k, alphabet[0]
    )


def target_pack_unpack(data: bytes) -> None:
    """Roundtrip identity incl. lowercase
    (reference: fuzz/fuzz_targets/fuzz_pack_unpack.rs)."""
    s = _derive_dna(data, "ACGTacgt")
    assert unpack_to_string(pack(s), len(s)) == s.upper()


def target_canonical(data: bytes) -> None:
    """Idempotence, RC-equivalence, lexicographic minimality
    (reference: fuzz/fuzz_targets/fuzz_canonical.rs)."""
    s = _derive_dna(data, "ACGT")
    k = len(s)
    bits = pack(s)
    canon, is_rc = canonical_packed(bits, k)
    again, again_rc = canonical_packed(canon, k)
    assert again == canon and not again_rc
    rc = "".join(_COMP[c] for c in reversed(s))
    canon_rc, _ = canonical_packed(pack(rc), k)
    assert canon_rc == canon
    assert canon <= bits and canon <= pack(rc)


TARGETS = {
    "from_sub": target_from_sub,
    "pack_unpack": target_pack_unpack,
    "canonical": target_canonical,
}


# --- mutation engine ---------------------------------------------------------


def mutate(rng: random.Random, data: bytes, corpus: list[bytes]) -> bytes:
    buf = bytearray(data)
    for _ in range(rng.randint(1, 4)):
        op = rng.randrange(7)
        if op == 0 and buf:  # bit flip
            i = rng.randrange(len(buf))
            buf[i] ^= 1 << rng.randrange(8)
        elif op == 1 and buf:  # interesting byte
            buf[rng.randrange(len(buf))] = rng.choice(_INTERESTING)
        elif op == 2 and buf:  # arithmetic
            i = rng.randrange(len(buf))
            buf[i] = (buf[i] + rng.randint(-8, 8)) & 0xFF
        elif op == 3 and len(buf) < 80:  # insert
            buf.insert(rng.randint(0, len(buf)), rng.randrange(256))
        elif op == 4 and buf:  # delete
            del buf[rng.randrange(len(buf))]
        elif op == 5 and corpus:  # splice with another corpus entry
            other = rng.choice(corpus)
            if other:
                cut = rng.randint(0, len(buf))
                buf = bytearray(bytes(buf[:cut]) + other[rng.randint(0, len(other)):])
        else:  # block duplicate
            if buf and len(buf) < 64:
                i = rng.randrange(len(buf))
                j = rng.randint(i, len(buf))
                buf[i:i] = buf[i:j]
    return bytes(buf[:256])


def fuzz(target_name: str, iterations: int, cov: EdgeCoverage) -> tuple[int, int]:
    """Evolve a corpus against one target; returns (edges, corpus size)."""
    target = TARGETS[target_name]
    rng = random.Random(0xC0FFEE + len(target_name))
    corpus: list[bytes] = [b"", b"ACGT", b"acgtACGT", b"NNNN", bytes(range(64))]
    for seed in list(corpus):
        _guarded(target, target_name, seed, cov)
    for i in range(iterations):
        parent = rng.choice(corpus)
        child = mutate(rng, parent, corpus)
        if _guarded(target, target_name, child, cov) > 0:
            corpus.append(child)
        if (i + 1) % 10000 == 0:
            print(
                f"[{target_name}] {i + 1} runs, {len(cov.seen)} edges, "
                f"corpus {len(corpus)}",
                flush=True,
            )
    return len(cov.seen), len(corpus)


def _guarded(target, name: str, data: bytes, cov: EdgeCoverage) -> int:
    try:
        return cov.run(target, data)
    except AssertionError:
        crash_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "crashes")
        os.makedirs(crash_dir, exist_ok=True)
        path = os.path.join(crash_dir, f"{name}_{abs(hash(data)):x}")
        with open(path, "wb") as f:
            f.write(data)
        print(f"BUG: {name} failed on {data!r} (saved to {path})", file=sys.stderr)
        raise SystemExit(1)


def main() -> None:
    iterations = int(sys.argv[1]) if len(sys.argv) > 1 else 20000
    which = sys.argv[2] if len(sys.argv) > 2 else "all"
    names = list(TARGETS) if which == "all" else [which]
    cov = EdgeCoverage()
    for name in names:
        edges, corpus = fuzz(name, iterations, cov)
        print(f"[{name}] done: {edges} total edges, corpus {corpus}")
    print("coverage-guided fuzz passed")


if __name__ == "__main__":
    main()
