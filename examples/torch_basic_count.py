"""Basic k-mer counting via the builder API
(reference: examples/basic_count.rs).

``examples/basic_count.py`` on ``krust_tpu_torch``: it counts on the GPU
when one is present, else on the native C++ core.

The simplest way to count k-mers: build a counter, point it at a FASTA
file, and print summary statistics plus the most frequent k-mers.

Usage::

    python examples/torch_basic_count.py <fasta_file> [k]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from krust_tpu_torch import KmerCounter
from krust_tpu_torch.errors import KrustError


def main() -> None:
    args = sys.argv[1:]
    if not args:
        prog = os.path.basename(sys.argv[0])
        print(f"Usage: {prog} <fasta_file> [k]", file=sys.stderr)
        print(file=sys.stderr)
        print("Arguments:", file=sys.stderr)
        print("  fasta_file  Path to a FASTA file", file=sys.stderr)
        print("  k           K-mer length (default: 21)", file=sys.stderr)
        sys.exit(1)

    path = args[0]
    k = int(args[1]) if len(args) > 1 else 21

    try:
        counter = KmerCounter().k(k)
    except KrustError as e:
        print(f"Invalid k-mer length: {e}", file=sys.stderr)
        sys.exit(1)
    try:
        counts = counter.count(path)
    except (KrustError, OSError) as e:
        print(f"Error counting k-mers: {e}", file=sys.stderr)
        sys.exit(1)

    total = sum(counts.values())
    max_count = max(counts.values(), default=0)
    print("K-mer counting complete!")
    print(f"  K-mer length: {k}")
    print(f"  Unique k-mers: {len(counts)}")
    print(f"  Total k-mers:  {total}")
    print(f"  Max count:     {max_count}")

    print("\nTop 10 most frequent k-mers:")
    ranked = sorted(counts.items(), key=lambda kv: (-kv[1], kv[0]))
    for kmer, count in ranked[:10]:
        print(f"  {kmer}: {count}")


if __name__ == "__main__":
    main()
