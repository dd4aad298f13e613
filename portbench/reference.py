"""The plain reference: canonical k-mer counting of a FASTA or FASTQ file,
in plain PyTorch on any device, written from the counting semantics alone
(it imports nothing of the port and takes nothing the port made).

Semantics, as kmerust counts (its ``src/run.rs`` window scan): every window
of ``k`` bases inside one record is counted when each of its bases is
A, C, G or T in either case and, with ``min_quality`` on FASTQ, each of
its quality bytes is at least ``min(min_quality + 33, 255)``. A window's
key is the smaller of its 2-bit code (A=0, C=1, G=2, T=3, first base
highest) and its reverse complement's.

Keys are held biased (the sign bit flipped), so that signed int64 order
is the unsigned order of the codes at every k up to 32.
"""

from __future__ import annotations

import torch

BIAS = -(1 << 63)
#: windows a block of the key computation holds
BLOCK = 1 << 26


def _lut(device) -> torch.Tensor:
    lut = torch.full((256,), 4, dtype=torch.uint8)
    for i, b in enumerate(b"ACGT"):
        lut[b] = i
        lut[b + 32] = i
    return lut.to(device)


def parse(data: torch.Tensor, fastq: bool):
    """Bytes of a file (uint8, on the device) -> (base codes 0-4, quality
    bytes or None, record index of each base). FASTQ is four lines a
    record; FASTA records start at lines that begin with '>'."""
    nl = data == 10
    line = torch.cumsum(nl, 0, dtype=torch.int64) - nl.long()
    body = ~nl & (data != 13)
    if fastq:
        role = line % 4
        seq_at = body & (role == 1)
        seq, qual = data[seq_at], data[body & (role == 3)]
        rec = line[seq_at] // 4
    else:
        starts = torch.cat([torch.zeros(1, dtype=torch.int64, device=data.device),
                            torch.nonzero(nl).flatten() + 1])
        starts = starts[starts < data.numel()]
        header = data[starts] == ord(">")
        # a line's record: the headers up to and including it
        rec_of_line = torch.cumsum(header, 0)
        seq_at = body & ~header[line]
        seq, qual = data[seq_at], None
        rec = rec_of_line[line[seq_at]]
    if qual is not None and qual.numel() != seq.numel():
        raise ValueError("FASTQ sequence and quality lengths differ")
    return _lut(data.device)[seq.long()], qual, rec


def window_keys(codes, bad, rec, k: int, narrow_bits: int | None = None):
    """Biased canonical keys of every valid window, block by block.
    ``narrow_bits`` keeps only the low bits of each code: the control."""
    n = codes.numel()
    w = n - k + 1
    if w <= 0:
        return torch.empty(0, dtype=torch.int64, device=codes.device)
    csum = torch.zeros(n + 1, dtype=torch.int64, device=codes.device)
    csum[1:] = torch.cumsum(bad, 0)
    out = []
    for s in range(0, w, BLOCK):
        b = min(BLOCK, w - s)
        valid = (csum[s + k:s + k + b] == csum[s:s + b]) & (
            rec[s:s + b] == rec[s + k - 1:s + k - 1 + b])
        fwd = torch.zeros(b, dtype=torch.int64, device=codes.device)
        rc = torch.zeros_like(fwd)
        for j in range(k):
            c = codes[s + j:s + j + b].long() & 3
            fwd = (fwd << 2) | c
            rc = rc | ((3 - c) << (2 * j))
        fwd, rc = fwd ^ BIAS, rc ^ BIAS
        key = torch.minimum(fwd, rc)[valid]
        if narrow_bits is not None:
            key = ((key ^ BIAS) & ((1 << narrow_bits) - 1)) ^ BIAS
        out.append(key)
    return torch.cat(out)


def count_table(data: torch.Tensor, fastq: bool, k: int, min_quality: int | None,
                narrow_bits: int | None = None):
    """(biased keys, counts) of the file's canonical k-mers, sorted by key:
    int64 tensors on ``data``'s device."""
    if not 1 <= k <= 32:
        raise ValueError(f"k = {k} outside 1..32")
    codes, qual, rec = parse(data, fastq)
    del data
    bad = codes == 4
    if qual is not None and min_quality is not None:
        bad |= qual < min(min_quality + 33, 255)
    keys = window_keys(codes, bad, rec, k, narrow_bits)
    del codes, qual, rec, bad
    keys = torch.sort(keys).values
    uniq, cnt = torch.unique_consecutive(keys, return_counts=True)
    return uniq, cnt


def histogram_bytes(counts: torch.Tensor) -> bytes:
    """Count-of-counts lines ``{count}\\t{distinct k-mers}\\n``, ascending."""
    vals, freqs = torch.unique(counts, return_counts=True)
    return "".join(f"{v}\t{f}\n" for v, f in zip(vals.tolist(), freqs.tolist())).encode()


def codes_of(keys: torch.Tensor) -> torch.Tensor:
    """Biased keys -> the codes as int64 bit patterns (uint64 when viewed)."""
    return keys ^ BIAS
