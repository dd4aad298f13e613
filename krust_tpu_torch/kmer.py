"""L0 k-mer core: validated k, 2-bit packing, canonicalization (host side).

This is the scalar/host-side half of the codec. It defines the *semantics*
(the device codec in :mod:`krust_tpu_torch.ops.fused_codec` must agree exactly) and serves
the paths where per-k-mer scalar work is the right tool: the ``query``
subcommand, unpacking device results to strings, and tests.

Encoding (reference: src/kmer.rs:21-50):
    A=00, C=01, G=10, T=11, first base in the most-significant position.
    Lowercase accepted and normalized to uppercase. k in [1, 32] so a k-mer
    packs into 64 bits.

Canonical form (reference: src/kmer.rs:348-390): the lexicographically
smaller of the k-mer and its reverse complement. Because A<C<G<T in both byte
order and 2-bit order, this equals the numerically smaller packed value.
"""

from __future__ import annotations

import numpy as np

from .errors import InvalidBaseError, KmerLengthError

# --- Constants ---------------------------------------------------------------

MIN_K = 1
MAX_K = 32

#: Sentinel code for a non-ACGT byte. Valid base codes are 0..3.
INVALID_CODE = 4

#: ASCII byte -> 2-bit code LUT; non-ACGT (incl. lowercase variants of other
#: letters) map to INVALID_CODE. Shared with the host packer.
BASE_LUT = np.full(256, INVALID_CODE, dtype=np.uint8)
for _b, _c in ((b"Aa", 0), (b"Cc", 1), (b"Gg", 2), (b"Tt", 3)):
    BASE_LUT[_b[0]] = _c
    BASE_LUT[_b[1]] = _c

#: 2-bit code -> ASCII byte.
UNPACK_LUT = np.frombuffer(b"ACGT", dtype=np.uint8)

_UNPACK_CHARS = "ACGT"


class KmerLength:
    """A validated k-mer length in [1, 32] (reference: src/kmer.rs:78-132).

    Instances are immutable and comparable; ``int(k)`` / ``k.get()`` return
    the plain value.
    """

    __slots__ = ("_k",)

    MIN = MIN_K
    MAX = MAX_K

    def __init__(self, k: int):
        if not isinstance(k, (int, np.integer)) or isinstance(k, bool):
            raise KmerLengthError(k)
        k = int(k)
        if k < MIN_K or k > MAX_K:
            raise KmerLengthError(k)
        self._k = k

    @classmethod
    def new_unchecked(cls, k: int) -> "KmerLength":
        """Skip validation; caller guarantees 1 <= k <= 32."""
        obj = object.__new__(cls)
        obj._k = k
        return obj

    def get(self) -> int:
        return self._k

    def __int__(self) -> int:
        return self._k

    def __index__(self) -> int:
        return self._k

    def __eq__(self, other) -> bool:
        if isinstance(other, KmerLength):
            return self._k == other._k
        if isinstance(other, int):
            return self._k == other
        return NotImplemented

    def __hash__(self) -> int:
        return hash(self._k)

    def __repr__(self) -> str:
        return f"KmerLength({self._k})"


def _as_k(k) -> int:
    """Coerce k (int or KmerLength) to a validated int."""
    if isinstance(k, KmerLength):
        return k.get()
    return KmerLength(k).get()


# --- Scalar codec -------------------------------------------------------------


def normalize(seq: bytes | str) -> bytes:
    """Validate and uppercase a candidate k-mer (reference: src/kmer.rs:266-286).

    Raises :class:`InvalidBaseError` with the 0-based position of the first
    non-ACGT byte. Lowercase acgt are normalized to uppercase.
    """
    if isinstance(seq, str):
        seq = seq.encode("ascii", errors="surrogateescape")
    out = bytearray(len(seq))
    for i, byte in enumerate(seq):
        code = BASE_LUT[byte]
        if code == INVALID_CODE:
            raise InvalidBaseError(byte, i)
        out[i] = UNPACK_LUT[code]
    return bytes(out)


def pack(seq: bytes | str) -> int:
    """Pack ACGT/acgt bytes into an int (reference: src/kmer.rs:467-471).

    Raises :class:`InvalidBaseError` on non-ACGT input. First base lands in
    the most-significant 2 bits.
    """
    if isinstance(seq, str):
        seq = seq.encode("ascii", errors="surrogateescape")
    acc = 0
    for i, byte in enumerate(seq):
        code = int(BASE_LUT[byte])
        if code == INVALID_CODE:
            raise InvalidBaseError(byte, i)
        acc = (acc << 2) | code
    return acc


def unpack_to_bytes(packed_bits: int, k) -> bytes:
    """Inverse of :func:`pack` (reference: src/kmer.rs:431-440).

    Only the low 2k bits are consulted, so any 64-bit value unpacks to a
    valid length-k ACGT sequence (a property the reference fuzzes).
    """
    kk = _as_k(k)
    return bytes(
        UNPACK_LUT[(packed_bits >> ((kk - 1 - i) * 2)) & 0b11] for i in range(kk)
    )


def unpack_to_string(packed_bits: int, k) -> str:
    """String flavor of :func:`unpack_to_bytes` (reference: src/kmer.rs:451-456)."""
    kk = _as_k(k)
    return "".join(
        _UNPACK_CHARS[(packed_bits >> ((kk - 1 - i) * 2)) & 0b11] for i in range(kk)
    )


def revcomp_packed(packed_bits: int, k) -> int:
    """Reverse complement of a packed k-mer, staying packed.

    Complement of a 2-bit code c is 3-c (A<->T, C<->G), and reversing the
    base order reverses the 2-bit groups.
    """
    kk = _as_k(k)
    out = 0
    for _ in range(kk):
        out = (out << 2) | (3 - (packed_bits & 0b11))
        packed_bits >>= 2
    return out


def canonical_packed(packed_bits: int, k) -> tuple[int, bool]:
    """Canonical (min of fwd/revcomp) packed value (reference: src/kmer.rs:348-390).

    Returns ``(canonical_bits, is_reverse_complement)``. Ties (palindromes)
    keep the forward orientation, matching the reference.
    """
    rc = revcomp_packed(packed_bits, k)
    if rc < packed_bits:
        return rc, True
    return packed_bits, False


def canonical_string(seq: bytes | str, k=None) -> str:
    """Validate, pack, canonicalize, and unpack a sequence in one call."""
    if isinstance(seq, str):
        seq_b = seq.encode("ascii", errors="surrogateescape")
    else:
        seq_b = bytes(seq)
    kk = _as_k(len(seq_b) if k is None else k)
    if len(seq_b) != kk:
        raise KmerLengthError(len(seq_b))
    bits, _ = canonical_packed(pack(seq_b), kk)
    return unpack_to_string(bits, kk)


# --- Kmer value type ------------------------------------------------------------


class Kmer:
    """A single validated k-mer with staged packing/canonicalization.

    Functional analog of the reference's ``Kmer<Unpacked/Packed/Canonical>``
    type-state machine (reference: src/kmer.rs:170-398): construction
    validates and normalizes, :meth:`pack` computes the 2-bit code, and
    :meth:`canonical` returns the canonical-form k-mer with
    ``is_reverse_complement`` tracking. Python enforces the staging by
    convention rather than types; methods are cheap and idempotent-safe.
    """

    __slots__ = ("_bytes", "_packed", "_is_rc")

    def __init__(self, seq: bytes, packed: int | None, is_rc: bool):
        self._bytes = seq
        self._packed = packed
        self._is_rc = is_rc

    @classmethod
    def from_sub(cls, seq: bytes | str) -> "Kmer":
        """Validate bytes into an unpacked k-mer (reference: src/kmer.rs:266-286).

        Raises :class:`InvalidBaseError` with the first bad position;
        lowercase is normalized.
        """
        return cls(normalize(seq), None, False)

    @property
    def bytes(self) -> bytes:
        return self._bytes

    def pack(self) -> "Kmer":
        """Compute the packed representation (reference: src/kmer.rs:304-313)."""
        return Kmer(self._bytes, pack(self._bytes), self._is_rc)

    @property
    def packed_bits(self) -> int:
        if self._packed is None:
            raise ValueError("k-mer is not packed yet: call .pack() first")
        return self._packed

    def canonical(self) -> "Kmer":
        """Canonical form: min(self, revcomp) (reference: src/kmer.rs:348-390)."""
        bits = self._packed if self._packed is not None else pack(self._bytes)
        cbits, is_rc = canonical_packed(bits, len(self._bytes))
        if is_rc:
            return Kmer(unpack_to_bytes(cbits, len(self._bytes)), cbits, True)
        return Kmer(self._bytes, cbits, False)

    @property
    def is_reverse_complement(self) -> bool:
        return self._is_rc

    def __len__(self) -> int:
        return len(self._bytes)

    def __repr__(self) -> str:
        return f"Kmer({self._bytes.decode()!r})"


class KmerBase:
    """Per-base byte <-> 2-bit conversions (reference: src/kmer.rs:477-624)."""

    A, C, G, T = 0, 1, 2, 3

    @staticmethod
    def from_byte(byte: int) -> int:
        code = BASE_LUT[byte]
        if code == INVALID_CODE:
            raise InvalidBaseError(byte, 0)
        return int(code)

    @staticmethod
    def to_byte(code: int) -> int:
        return int(UNPACK_LUT[code & 0b11])

    @staticmethod
    def complement(code: int) -> int:
        return 3 - (code & 0b11)


# --- Vectorized host helpers (numpy) ------------------------------------------


def encode_bytes(buf: bytes | np.ndarray) -> np.ndarray:
    """ASCII bytes -> uint8 codes (0..3 valid, 4 invalid), vectorized."""
    arr = np.frombuffer(buf, dtype=np.uint8) if isinstance(buf, bytes) else buf
    return BASE_LUT[arr]


def unpack_char_matrix(codes: np.ndarray, k) -> np.ndarray:
    """Unpack a uint64 array of packed k-mers to an [n, k] ASCII byte matrix.

    The fully-vectorized core of the bulk output path: downstream byte
    assembly (TSV/FASTA emission, string building) consumes the matrix
    without any per-entry Python (reference's parallel unpack:
    src/run.rs:573-583).
    """
    kk = _as_k(k)
    codes = np.asarray(codes, dtype=np.uint64)
    out = np.empty((codes.shape[0], kk), np.uint8)
    fill_kmer_columns(out, 0, codes, kk)
    return out


def fill_kmer_columns(out: np.ndarray, col0: int, codes: np.ndarray, k: int) -> None:
    """Write k-mer ASCII chars into ``out[:, col0:col0+k]``, column-wise.

    Column-at-a-time keeps peak intermediates at one [n] uint64 lane instead
    of an [n, k] uint64 broadcast (2.7 GB at 16M x 21 — measured pathological
    on a small host).
    """
    three = np.uint64(3)
    for j in range(k):
        shift = np.uint64(2 * (k - 1 - j))
        out[:, col0 + j] = UNPACK_LUT[((codes >> shift) & three).astype(np.uint8)]


def unpack_many(codes: np.ndarray, k) -> list[str]:
    """Unpack a uint64 array of packed k-mers to strings, vectorized."""
    kk = _as_k(k)
    codes = np.asarray(codes, dtype=np.uint64)
    n = codes.shape[0]
    if n == 0:
        return []
    flat = unpack_char_matrix(codes, kk).tobytes()
    return [flat[i * kk : (i + 1) * kk].decode("ascii") for i in range(n)]


def pack_many(kmers: list[str] | list[bytes]) -> np.ndarray:
    """Pack a list of equal-length ACGT strings to uint64 codes, vectorized.

    Input must already be validated/canonical-cased (used when converting
    string-keyed results back to packed for .kmix saving; reference:
    src/main.rs:284-299).
    """
    if not kmers:
        return np.zeros(0, dtype=np.uint64)
    first = kmers[0]
    kk = len(first)
    joined = (
        "".join(kmers).encode("ascii")
        if isinstance(first, str)
        else b"".join(kmers)
    )
    arr = BASE_LUT[np.frombuffer(joined, dtype=np.uint8)].astype(np.uint64)
    mat = arr.reshape(-1, kk)
    shifts = np.arange(kk - 1, -1, -1, dtype=np.uint64) * np.uint64(2)
    return (mat << shifts[None, :]).sum(axis=1, dtype=np.uint64)
