"""Memory-bounded k-mer counting for files larger than memory
(reference: examples/streaming_large_file.rs).

``examples/streaming_large_file.py`` on ``krust_tpu_torch``: it counts on
the GPU when one is present, else on the native C++ core.

Streams the input through record-aligned chunks so neither the raw bytes
nor the parsed sequences ever materialize whole: host RSS is bounded by
``ingest_chunk_bytes`` and device memory by the shared epoch table that
persists across chunks. Filtered TSV goes to stdout like the reference.

Usage::

    python examples/torch_streaming_large_file.py <fasta_file> [k] [min_count]

Without arguments, synthesizes an 8 Mbase multi-record FASTA to count.
"""

import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from krust_tpu_torch import Input, count_with_input
from krust_tpu_torch.errors import KrustError
from krust_tpu_torch.utils.config import EngineConfig


def _synthesize(path: str, mbases: int = 8) -> None:
    """Write a synthetic multi-record FASTA of ~mbases Mbases."""
    import numpy as np

    rng = np.random.default_rng(0)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    with open(path, "wb") as f:
        for i in range(mbases):
            seq = bases[rng.integers(0, 4, size=1_000_000)].tobytes()
            f.write(b">contig%d\n" % i + seq + b"\n")


def main() -> None:
    args = sys.argv[1:]
    if args:
        path = args[0]
    else:
        prog = os.path.basename(sys.argv[0])
        print(f"Usage: {prog} <fasta_file> [k] [min_count]", file=sys.stderr)
        print(file=sys.stderr)
        print("Arguments:", file=sys.stderr)
        print("  fasta_file  Path to a FASTA file", file=sys.stderr)
        print("  k           K-mer length (default: 21)", file=sys.stderr)
        print("  min_count   Minimum count threshold (default: 1)",
              file=sys.stderr)
        print(file=sys.stderr)
        path = os.path.join(tempfile.gettempdir(), "krust_example_large.fa")
        if not os.path.exists(path):
            print(f"No input given: synthesizing an 8 Mbase FASTA at {path}",
                  file=sys.stderr)
            _synthesize(path)
        else:
            print(f"No input given: reusing {path}", file=sys.stderr)
    k = int(args[1]) if len(args) > 1 else 21
    min_count = int(args[2]) if len(args) > 2 else 1

    print(f"Counting {k}-mers in {path} (streaming mode)...", file=sys.stderr)
    print(f"Minimum count threshold: {min_count}", file=sys.stderr)

    # bounded host AND device memory: ingest_chunk_bytes streams the file
    # through record-aligned chunks feeding one shared device table
    cfg = EngineConfig(ingest_chunk_bytes=32 << 20)
    try:
        result = count_with_input(Input.from_path(path), k, config=cfg)
    except (KrustError, OSError) as e:
        print(f"Error counting k-mers: {e}", file=sys.stderr)
        sys.exit(1)

    kept = [
        (kmer, count)
        for kmer, count in result.to_string_dict().items()
        if count >= min_count
    ]
    print(f"Found {len(kept)} unique k-mers with count >= {min_count}",
          file=sys.stderr)
    for kmer, count in kept:
        print(f"{kmer}\t{count}")


if __name__ == "__main__":
    main()
