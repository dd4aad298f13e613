"""The generators: deterministic by seed, fixed sizes, the stated shares."""

import hashlib

import numpy as np
import pytest

from portbench import gen

from .helpers import CPU, tiny_cell


def _digest(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


@pytest.mark.parametrize("cell", ["readset_k21_clean", "assembly_k31_hist"])
def test_same_seed_same_file_other_seed_same_size(tmp_path, cell):
    c = tiny_cell(cell)
    paths = [tmp_path / f"{i}{c.traffic['suffix']}" for i in range(3)]
    seeds = [2**31 + 11, 2**31 + 11, 2**31 + 12]
    stats = [gen.write_input(str(p), s, CPU, c.config, c.traffic) for p, s in zip(paths, seeds)]
    assert _digest(paths[0]) == _digest(paths[1])
    assert _digest(paths[0]) != _digest(paths[2])
    assert paths[0].stat().st_size == paths[2].stat().st_size
    assert stats[0] == stats[1] and stats[0]["bases"] == stats[2]["bases"]


def test_reads_give_the_stated_shares(tmp_path):
    c = tiny_cell("readset_k21_clean")
    cfg = dict(c.config, total_bases=3_000_000, genome_bases=100_000)
    mix = c.traffic
    s = gen.write_input(str(tmp_path / "r.fq"), 7, CPU, cfg, mix)
    n = s["bases"]
    assert n == 3_000_000 // cfg["read_length"] * cfg["read_length"]
    # substitutions land 3/4 on another base of the 4: P(error) = error_rate
    for key, rate in (("n_bases", mix["n_rate"]), ("substituted", mix["error_rate"])):
        assert abs(s[key] / n - rate) < 5 * (rate / n) ** 0.5, key
    assert s["below_q20"] == s["n_bases"]  # the N at '#', every other base at 'F'
    data = np.fromfile(tmp_path / "r.fq", np.uint8)
    lines = bytes(data).split(b"\n")[:-1]
    assert len(lines) == 4 * (n // cfg["read_length"])
    assert all(len(x) == cfg["read_length"] for x in lines[1::4] + lines[3::4])
    assert set(lines[0::4]) == {b"@r"} and set(lines[2::4]) == {b"+"}
    for seq, qual in zip(lines[1::4], lines[3::4]):
        assert [b == ord("N") for b in seq] == [q == ord("#") for q in qual]
    assert set(b"".join(lines[3::4])) <= {ord("#"), ord("F")}


def test_quality_bins_follow_the_profile_along_the_read():
    g = gen.generator(5, CPU)
    quality = {"phred": [2, 12, 23, 37], "first": [0.0, 0.0, 0.1, 0.9],
               "last": [0.1, 0.2, 0.3, 0.4]}
    q = gen._quality_bins(g, CPU, 200_000, 11, quality).numpy()
    assert set(np.unique(q)) <= {35, 45, 56, 70}
    for at, share in ((0, quality["first"]), (10, quality["last"]), (5, [0.05, 0.1, 0.2, 0.65])):
        got = [(q[:, at] == p + 33).mean() for p in quality["phred"]]
        assert np.allclose(got, share, atol=0.005), (at, got)


def test_genome_gives_grch38_records_gaps_and_repeats(tmp_path):
    c = tiny_cell("assembly_k31_hist")
    cfg = dict(c.config, total_bases=8_000_000)
    s = gen.write_input(str(tmp_path / "g.fa"), 3, CPU, cfg, c.traffic)
    data = bytes(np.fromfile(tmp_path / "g.fa", np.uint8))
    heads = [x for x in data.split(b"\n") if x.startswith(b">")]
    assert heads == [b">" + n.encode() for n in gen.GRCH38_NAMES]
    body = [x for x in data.split(b"\n") if x and not x.startswith(b">")]
    assert {len(x) for x in body} == {c.traffic["line"]}
    assert s["bases"] == sum(len(x) for x in body)
    records = data.split(b">")[1:]
    for rec in records:  # exactly the gap share of each record is N
        seq = b"".join(rec.split(b"\n")[1:])
        assert seq.count(b"N") == int(len(seq) * cfg["n_share"])
    assert s["n_bases"] == sum(b"".join(r.split(b"\n")[1:]).count(b"N") for r in records)
    # the repeat copies, soft-masked, hold the classes' share of what is not N
    rep = sum(r["share"] for r in cfg["repeats"])
    assert abs(s["soft_bases"] / (s["bases"] - s["n_bases"]) - rep) < 0.02
    # copies of one consensus share k-mers: far fewer distinct 31-mers in
    # the lower case than windows, and nearly all distinct in the upper
    seq = b"".join(b"".join(r.split(b"\n")[1:]) for r in records)
    low = [seq[i:i + 31] for i in range(0, len(seq) - 31, 7) if seq[i:i + 31].islower()]
    up = [seq[i:i + 31] for i in range(0, len(seq) - 31, 7) if seq[i:i + 31].isupper()
          and b"N" not in seq[i:i + 31]]
    assert len(set(low)) < 0.97 * len(low)
    assert len(set(up)) > 0.999 * len(up)
