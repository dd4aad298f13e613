"""The inputs, made from the seed on the device in a few large calls and
written to a file that the port and the reference both read.

Started from chip_smoke.py's ``write_reads`` and ``write_genome`` (the
same record shapes), moved onto a ``torch.Generator`` on the device, with
substitution errors and binned qualities added to the reads, and repeat
copies and GRCh38's gap share to the genome. One seed gives the same file
on one device type; every seed gives the same sizes.
"""

from __future__ import annotations

import torch

#: GRCh38's chromosome lengths in Mbases, chr1-22, X, Y (GCF_000001405.26)
GRCH38_MB = [248, 242, 198, 190, 181, 171, 159, 145, 138, 134, 135, 133, 114, 107,
             102, 90, 83, 80, 59, 64, 47, 51, 156, 57]
GRCH38_NAMES = [f"chr{i}" for i in range(1, 23)] + ["chrX", "chrY"]


def generator(seed: int, device: torch.device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 64))
    return g


def _acgt(device) -> torch.Tensor:
    return torch.tensor(list(b"ACGT"), dtype=torch.uint8, device=device)


def _bytes(device, s: bytes) -> torch.Tensor:
    return torch.tensor(list(s), dtype=torch.uint8, device=device)


def _quality_bins(g, device, nr: int, L: int, quality: dict) -> torch.Tensor:
    """Phred bytes for ``nr`` reads of ``L`` bases: each base falls in one of
    ``quality["phred"]``'s bins, the bins' shares moving linearly from
    ``quality["first"]`` at the read's first base to ``quality["last"]`` at
    its last."""
    first = torch.tensor(quality["first"], dtype=torch.float64, device=device)
    last = torch.tensor(quality["last"], dtype=torch.float64, device=device)
    at = torch.linspace(0.0, 1.0, L, dtype=torch.float64, device=device)[:, None]
    cum = torch.cumsum(first + (last - first) * at, dim=1)  # (L, bins)
    u = torch.rand((nr, L), generator=g, device=device, dtype=torch.float64)
    b = (u[..., None] >= cum[None, :, :-1]).sum(-1)
    return (torch.tensor(quality["phred"], device=device) + 33).to(torch.uint8)[b]


def write_reads(path: str, seed: int, device: torch.device, *, total_bases: int,
                genome_bases: int, read_length: int, error_rate: float, n_rate: float,
                quality: dict, chunk_reads: int = 1 << 20) -> dict:
    """A FASTQ read set: ``total_bases // read_length`` single-end reads at
    uniform random positions of one random genome of ``genome_bases``,
    forward strand; each base substituted by another with probability
    ``error_rate`` and made N, at quality '#' (Q2), with ``n_rate``; the
    other bases' qualities drawn from ``quality`` (see ``_quality_bins``).
    Returns the bases written and how many were N, below Q20 and
    substituted."""
    g = generator(seed, device)
    L = read_length
    genome = torch.randint(0, 4, (genome_bases,), generator=g, device=device,
                           dtype=torch.uint8)
    acgt, off = _acgt(device), torch.arange(L, device=device)
    head, plus = _bytes(device, b"@r\n"), _bytes(device, b"+\n")
    n_reads = total_bases // L
    stats = {"bases": n_reads * L, "n_bases": 0, "below_q20": 0, "substituted": 0}
    with open(path, "wb") as f:
        for r0 in range(0, n_reads, chunk_reads):
            nr = min(chunk_reads, n_reads - r0)
            starts = torch.randint(0, genome_bases - L + 1, (nr,), generator=g,
                                   device=device)
            seq = genome[starts[:, None] + off]
            err = torch.rand((nr, L), generator=g, device=device) < error_rate
            shift = torch.randint(1, 4, (nr, L), generator=g, device=device,
                                  dtype=torch.uint8)
            seq = torch.where(err, (seq + shift) % 4, seq)
            seq = acgt[seq.long()]
            is_n = torch.rand((nr, L), generator=g, device=device) < n_rate
            seq[is_n] = ord("N")
            qual = _quality_bins(g, device, nr, L, quality)
            qual[is_n] = ord("#")
            nl = torch.full((nr, 1), ord("\n"), dtype=torch.uint8, device=device)
            rec = torch.cat([head.expand(nr, 3), seq, nl, plus.expand(nr, 2), qual, nl],
                            dim=1)
            f.write(rec.cpu().numpy().tobytes())
            stats["n_bases"] += int(is_n.sum())
            stats["below_q20"] += int((qual < 20 + 33).sum())
            stats["substituted"] += int(err.sum())
    return stats


def _repeat_layout(g, device, n: int, repeats: list, divergence: list,
                   consensus: torch.Tensor, cons_at: torch.Tensor) -> tuple:
    """One record's bases (codes 0-3) and its repeat mask: unique random
    stretches alternating with copies of the repeat classes' consensus
    sequences. A copy's class is drawn in proportion to the class's copies
    (share over mean length); its length uniformly within half its class's
    mean length either side, at most the consensus; its start uniformly in
    the consensus; each of its bases substituted with the copy's
    divergence, drawn uniformly from ``divergence``. The unique stretches
    are drawn uniformly from 1 to twice the length that keeps the classes'
    total share."""
    share = torch.tensor([r["share"] for r in repeats], dtype=torch.float64, device=device)
    mean = torch.tensor([r["mean_length"] for r in repeats], dtype=torch.float64,
                        device=device)
    cons_len = torch.tensor([r["consensus_length"] for r in repeats], device=device)
    weight = share / mean
    mean_copy = float(share.sum() / weight.sum())
    mean_gap = mean_copy * (1.0 - float(share.sum())) / float(share.sum())
    m = int(n / (mean_copy + mean_gap) * 1.25) + 64
    cls = torch.multinomial(weight, m, replacement=True, generator=g)
    u = torch.rand((4, m), generator=g, device=device, dtype=torch.float64)
    length = torch.minimum((mean[cls] * (0.5 + u[0])).long().clamp_(min=1), cons_len[cls])
    gap = (2.0 * mean_gap * u[1]).long() + 1
    start = (u[2] * (cons_len[cls] - length + 1)).long()
    div = divergence[0] + (divergence[1] - divergence[0]) * u[3]
    seg_len = torch.stack([gap, length], 1).flatten()
    seg_end = torch.cumsum(seg_len, 0)
    if int(seg_end[-1]) < n:
        raise ValueError("repeat layout too short for the record")
    seg = torch.repeat_interleave(torch.arange(2 * m, device=device), seg_len)[:n]
    pos = torch.arange(n, device=device) - (seg_end - seg_len)[seg]
    copy, is_rep = seg // 2, seg % 2 == 1
    idx = torch.where(is_rep, cons_at[cls[copy]] + start[copy] + pos, 0)
    rep = consensus[idx]
    mutate = torch.rand(n, generator=g, device=device, dtype=torch.float64) < div[copy]
    shift = torch.randint(1, 4, (n,), generator=g, device=device, dtype=torch.uint8)
    rep = torch.where(mutate, (rep + shift) % 4, rep)
    unique = torch.randint(0, 4, (n,), generator=g, device=device, dtype=torch.uint8)
    return torch.where(is_rep, rep, unique), is_rep


def write_genome(path: str, seed: int, device: torch.device, *, total_bases: int,
                 line: int, n_run: list, n_share: float, repeats: list,
                 divergence: list) -> dict:
    """A genome-shaped FASTA: 24 records (chr1-22, X, Y) in GRCh38's
    proportions, scaled to ``total_bases``. One random consensus sequence
    a repeat class; each record's bases as ``_repeat_layout`` lays them
    out, the repeat copies soft-masked (lower case) as RepeatMasker marks
    them; then runs of N of ``n_run`` bases at random places until exactly
    ``n_share`` of the record is N; ``line`` bases a line. Returns the
    bases written, the N and the lower-case bases."""
    g = generator(seed, device)
    acgt = _acgt(device)
    cons_len = [r["consensus_length"] for r in repeats]
    consensus = torch.randint(0, 4, (sum(cons_len),), generator=g, device=device,
                              dtype=torch.uint8)
    cons_at = torch.tensor([0] + cons_len[:-1], device=device).cumsum(0)
    scale = total_bases / sum(GRCH38_MB)
    lengths = [int(mb * scale) // line * line for mb in GRCH38_MB]
    stats = {"bases": sum(lengths), "n_bases": 0, "soft_bases": 0, "records": 24}
    with open(path, "wb") as f:
        for name, n in zip(GRCH38_NAMES, lengths):
            codes, is_rep = _repeat_layout(g, device, n, repeats, divergence, consensus,
                                           cons_at)
            seq = acgt[codes.long()] | (is_rep.to(torch.uint8) << 5)  # repeats lower case
            is_n = torch.zeros(n, dtype=torch.bool, device=device)
            n_target, covered = int(n * n_share), 0
            while covered < n_target:
                run = min(int(torch.randint(n_run[0], n_run[1] + 1, (1,), generator=g,
                                            device=device)), n_target - covered)
                at = int(torch.randint(0, n - run + 1, (1,), generator=g, device=device))
                is_n[at:at + run] = True
                covered = int(is_n.sum())
            seq[is_n] = ord("N")
            rows = torch.empty((n // line, line + 1), dtype=torch.uint8, device=device)
            rows[:, :line] = seq.view(-1, line)
            rows[:, line] = ord("\n")
            f.write(b">" + name.encode() + b"\n")
            f.write(rows.cpu().numpy().tobytes())
            stats["n_bases"] += covered
            stats["soft_bases"] += int((is_rep & ~is_n).sum())
    return stats


def write_input(path: str, seed: int, device: torch.device, config: dict,
                traffic: dict) -> dict:
    """The cell's input file: the traffic's kind of generator at the
    configuration's scale and, for a genome, its gap share and repeats."""
    if traffic["kind"] == "reads":
        return write_reads(
            path, seed, device, total_bases=config["total_bases"],
            genome_bases=config["genome_bases"], read_length=config["read_length"],
            error_rate=traffic["error_rate"], n_rate=traffic["n_rate"],
            quality=traffic["quality"])
    if traffic["kind"] == "genome":
        return write_genome(
            path, seed, device, total_bases=config["total_bases"],
            line=traffic["line"], n_run=traffic["n_run"], n_share=config["n_share"],
            repeats=config["repeats"], divergence=config["divergence"])
    raise ValueError(f"unknown traffic kind {traffic['kind']!r}")
