"""Async k-mer counting with the AsyncKmerCounter builder
(reference: examples/async_count.rs).

``examples/async_count.py`` on ``krust_tpu_torch``: it counts on the GPU
when one is present, else on the native C++ core.

Demonstrates the async API for integration with asyncio event loops: the
counting work runs on a worker thread (the analog of the reference's
``tokio::task::spawn_blocking``) while the loop stays responsive. Also
shows concurrent counts over several files via ``asyncio.gather``.

Usage::

    python examples/torch_async_count.py <fasta_file> [more_files...] [-k K]
"""

import asyncio
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from krust_tpu_torch import AsyncKmerCounter
from krust_tpu_torch.errors import KrustError


async def main() -> None:
    args = sys.argv[1:]
    k = 21
    if "-k" in args:
        i = args.index("-k")
        k = int(args[i + 1])
        del args[i : i + 2]
    if not args:
        prog = os.path.basename(sys.argv[0])
        print(f"Usage: {prog} <fasta_file> [more_files...] [-k K]",
              file=sys.stderr)
        print(file=sys.stderr)
        print("Arguments:", file=sys.stderr)
        print("  fasta_file  Path(s) to FASTA/FASTQ files", file=sys.stderr)
        print("  -k K        K-mer length (default: 21)", file=sys.stderr)
        sys.exit(1)

    try:
        counter = AsyncKmerCounter.new().k(k)
    except KrustError as e:
        print(f"Invalid k-mer length: {e}", file=sys.stderr)
        sys.exit(1)

    print(f"Counting {k}-mers in {len(args)} file(s) (async mode)...",
          file=sys.stderr)
    try:
        results = await asyncio.gather(*(counter.count(p) for p in args))
    except (KrustError, OSError) as e:
        print(f"Error counting k-mers: {e}", file=sys.stderr)
        sys.exit(1)

    for path, counts in zip(args, results):
        print(f"{path}: {len(counts)} unique k-mers", file=sys.stderr)

    # merge and show the top 10 across all inputs
    merged: dict[str, int] = {}
    for counts in results:
        for kmer, count in counts.items():
            merged[kmer] = merged.get(kmer, 0) + count
    ranked = sorted(merged.items(), key=lambda kv: (-kv[1], kv[0]))
    print("\nTop 10 most frequent k-mers:")
    for kmer, count in ranked[:10]:
        print(f"{kmer}\t{count}")


if __name__ == "__main__":
    asyncio.run(main())
