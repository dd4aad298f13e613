"""Shared pieces of the benchmark's tests: tiny cells on the CPU and a
brute-force counter."""

from __future__ import annotations

import os

import torch

from portbench import spec

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
#: each cell cut to a size a CPU test holds
TINY = {"readset_k21_clean": {"total_bases": 300_000, "genome_bases": 20_000},
        "assembly_k31_hist": {"total_bases": 400_000}}
CPU = torch.device("cpu")


def tiny_cell(name: str) -> spec.Cell:
    cell = spec.Cell(spec.benchmark(ROOT), name)
    cell.config = dict(cell.config, **TINY[name])
    return cell


_COMP = {"A": "T", "C": "G", "G": "C", "T": "A"}


def brute_count(records, k, min_quality=None):
    """records: (sequence, quality or None); a dict of canonical k-mer
    strings -> counts, by the definition, one window at a time."""
    out = {}
    for seq, qual in records:
        for i in range(len(seq) - k + 1):
            win = seq[i:i + k].upper()
            if any(c not in _COMP for c in win):
                continue
            if qual is not None and min_quality is not None and any(
                    ord(q) < min(min_quality + 33, 255) for q in qual[i:i + k]):
                continue
            rc = "".join(_COMP[c] for c in reversed(win))
            key = min(win, rc)
            out[key] = out.get(key, 0) + 1
    return out


def code_of(kmer: str) -> int:
    v = 0
    for c in kmer:
        v = (v << 2) | "ACGT".index(c)
    return v
