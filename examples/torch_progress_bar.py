"""K-mer counting with live progress reporting
(reference: examples/progress_bar.rs).

``examples/progress_bar.py`` on ``krust_tpu_torch``: it counts on the GPU
when one is present, else on the native C++ core.

Demonstrates the progress-callback API: a same-line progress indicator
with SI-formatted base counts, throttled to one update per 100 sequences,
followed by a results summary with throughput and the top k-mers.

Usage::

    python examples/torch_progress_bar.py <fasta_file> [k]
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from krust_tpu_torch import KmerCounter, Progress
from krust_tpu_torch.errors import KrustError


def format_bases(bases: float) -> str:
    """Format a base count with an SI prefix (K, M, G)."""
    if bases >= 1_000_000_000:
        return f"{bases / 1_000_000_000:.2f}G"
    if bases >= 1_000_000:
        return f"{bases / 1_000_000:.2f}M"
    if bases >= 1_000:
        return f"{bases / 1_000:.2f}K"
    return f"{int(bases)}"


def main() -> None:
    args = sys.argv[1:]
    if not args:
        prog = os.path.basename(sys.argv[0])
        print(f"Usage: {prog} <fasta_file> [k]", file=sys.stderr)
        print(file=sys.stderr)
        print("Demonstrates progress reporting during k-mer counting.",
              file=sys.stderr)
        sys.exit(1)

    path = args[0]
    k = int(args[1]) if len(args) > 1 else 21

    print(f"Counting {k}-mers in {path}...\n", file=sys.stderr)

    # only update every 100 sequences to keep callback overhead negligible
    last = {"seqs": 0, "bases": 0}

    def on_progress(p: Progress) -> None:
        if (
            p.sequences_processed >= last["seqs"] + 100
            or p.sequences_processed < last["seqs"]
        ):
            last["seqs"] = p.sequences_processed
            last["bases"] = p.bases_processed
            print(
                f"\r  Sequences: {p.sequences_processed:>8}  |  "
                f"Bases: {format_bases(p.bases_processed):>10}",
                end="",
                file=sys.stderr,
                flush=True,
            )

    start = time.perf_counter()
    try:
        counts = (
            KmerCounter().k(k).count_with_progress(path, on_progress)
        )
    except (KrustError, OSError) as e:
        print(f"\nError: {e}", file=sys.stderr)
        sys.exit(1)
    elapsed = time.perf_counter() - start

    # clear the progress line, then summarize
    print(f"\r{'':60}", file=sys.stderr)
    print("\n=== Results ===", file=sys.stderr)
    print(f"Unique k-mers:    {len(counts)}", file=sys.stderr)
    print(f"Processing time:  {elapsed:.2f}s", file=sys.stderr)
    if elapsed > 0 and last["bases"] > 0:
        rate = last["bases"] / elapsed
        print(f"Throughput:       {format_bases(rate)} bases/sec",
              file=sys.stderr)

    ranked = sorted(counts.items(), key=lambda kv: (-kv[1], kv[0]))
    print("\nTop 10 k-mers:", file=sys.stderr)
    for kmer, count in ranked[:10]:
        print(f"  {kmer}: {count}", file=sys.stderr)


if __name__ == "__main__":
    main()
