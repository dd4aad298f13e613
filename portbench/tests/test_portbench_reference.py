"""The plain reference against a brute-force counter and against the
port's CPU engine."""

import random

import numpy as np
import pytest
import torch

from portbench import compare, gen, reference

from .helpers import CPU, brute_count, code_of, tiny_cell


def _records(rng, n, fastq):
    recs = []
    for _ in range(n):
        length = rng.randint(0, 90)
        seq = "".join(rng.choice("ACGTACGTACGTacgtNNR") for _ in range(length))
        qual = "".join(rng.choice("II5#+") for _ in range(length)) if fastq else None
        recs.append((seq, qual))
    return recs


def _file(recs, fastq, line=17):
    out = []
    for i, (seq, qual) in enumerate(recs):
        if fastq:
            out.append(f"@r{i}\n{seq}\n+\n{qual}\n")
        else:
            body = "".join(seq[j:j + line] + "\n" for j in range(0, len(seq), line))
            out.append(f">r{i} some words\n{body}")
    return "".join(out).encode()


@pytest.mark.parametrize("k", [1, 21, 31, 32])
@pytest.mark.parametrize("fastq,min_quality", [(False, None), (True, None), (True, 20)])
def test_reference_equals_brute_force(k, fastq, min_quality):
    rng = random.Random(k * 7 + fastq + (min_quality or 0))
    recs = _records(rng, 60, fastq)
    data = torch.frombuffer(bytearray(_file(recs, fastq)), dtype=torch.uint8)
    keys, counts = reference.count_table(data, fastq, k, min_quality)
    want = brute_count(recs, k, min_quality)
    got_codes = reference.codes_of(keys).numpy().view(np.uint64).tolist()
    assert dict(zip(got_codes, counts.tolist())) == {code_of(km): c for km, c in want.items()}
    assert got_codes == sorted(got_codes)  # sorted as unsigned codes, k = 32 too
    assert compare.entries_off(np.array(sorted(code_of(km) for km in want), np.uint64),
                               np.array([want[km] for km in sorted(want, key=code_of)],
                                        np.uint64), keys, counts) == 0


def test_histogram_bytes():
    counts = torch.tensor([3, 1, 1, 7, 3, 1])
    assert reference.histogram_bytes(counts) == b"1\t3\n3\t2\n7\t1\n"


def test_entries_off_counts_each_difference():
    keys = torch.tensor([1, 5, 9]) ^ reference.BIAS
    counts = torch.tensor([2, 1, 4])
    u = lambda xs: np.array(xs, np.uint64)  # noqa: E731
    assert compare.entries_off(u([1, 5, 9]), u([2, 1, 4]), keys, counts) == 0
    assert compare.entries_off(u([1, 5, 9]), u([2, 2, 4]), keys, counts) == 2
    assert compare.entries_off(u([1, 9]), u([2, 4]), keys, counts) == 1
    assert compare.entries_off(u([1, 5, 5, 9]), u([2, 1, 1, 4]), keys, counts) == 1
    assert compare.entries_off(u([]), u([]), keys, counts) == 3
    assert compare.outputs_off([b"a", b"b", b"a"], b"a") == 1


@pytest.mark.parametrize("cell", ["readset_k21_clean", "assembly_k31_hist"])
def test_reference_equals_the_ports_cpu_engine(tmp_path, monkeypatch, cell):
    monkeypatch.setenv("KRUST_PLATFORM", "cpu")
    from portbench import spec

    c = tiny_cell(cell)
    path = str(tmp_path / ("in" + c.traffic["suffix"]))
    gen.write_input(path, 2**31 + 99, CPU, c.config, c.traffic)
    entry = spec.entry(c.traffic["entry"])
    result = entry.run(path, c.config)
    data = torch.from_numpy(np.fromfile(path, np.uint8))
    keys, counts = reference.count_table(data, c.traffic["suffix"] == ".fq", c.config["k"],
                                         c.config["min_quality"])
    assert keys.numel() > 1000
    assert compare.entries_off(result.codes, result.counts, keys, counts) == 0
    if c.config["output"]:
        assert entry.output(result, c.config) == reference.histogram_bytes(counts)

