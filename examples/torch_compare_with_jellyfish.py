"""Differential check against Jellyfish, when installed
(reference: examples/compare_with_jellyfish.rs, tests/jellyfish_compat.rs).

``examples/compare_with_jellyfish.py`` on ``krust_tpu_torch``: it counts on
the GPU when one is present, else on the native C++ core.

Counts k-mers with krust_tpu_torch, then — if a ``jellyfish`` binary is on
PATH — runs ``jellyfish count -m k -s 100M -C`` + ``jellyfish dump -c`` on the same
input and diffs the full canonical count maps, printing the first few
mismatches and a comparison summary. Without jellyfish it prints a summary
of the krust_tpu_torch results alone.

Usage::

    python examples/torch_compare_with_jellyfish.py <fasta_file> [k]
"""

import os
import shutil
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import krust_tpu_torch as kt
from krust_tpu_torch.errors import KrustError


def run_jellyfish(path: str, k: int) -> dict[str, int] | None:
    """Canonical jellyfish counts for ``path``, or None when not installed."""
    if shutil.which("jellyfish") is None:
        return None

    print(f"Counting {k}-mers with Jellyfish...", file=sys.stderr)
    with tempfile.NamedTemporaryFile(suffix=".jf") as tmp:
        status = subprocess.run(
            ["jellyfish", "count", "-m", str(k), "-s", "100M", "-C",
             "-o", tmp.name, path],
        )
        if status.returncode != 0:
            print("Jellyfish count failed", file=sys.stderr)
            return None
        dump = subprocess.run(
            ["jellyfish", "dump", "-c", tmp.name],
            capture_output=True,
            text=True,
        )
        if dump.returncode != 0:
            print("Jellyfish dump failed", file=sys.stderr)
            return None

    counts: dict[str, int] = {}
    for line in dump.stdout.splitlines():
        parts = line.split()
        if len(parts) == 2:
            counts[parts[0]] = int(parts[1])
    print(f"Jellyfish found {len(counts)} unique canonical k-mers",
          file=sys.stderr)
    return counts


def compare_counts(ours: dict[str, int], jellyfish: dict[str, int]) -> bool:
    """Diff the two maps, print details + summary; True when identical."""
    mismatches = 0
    ours_only = 0
    for kmer, count in ours.items():
        jf = jellyfish.get(kmer)
        if jf is None:
            ours_only += 1
        elif jf != count:
            if mismatches < 5:
                print(f"  Mismatch: {kmer} krust_tpu_torch={count} jellyfish={jf}",
                      file=sys.stderr)
            mismatches += 1
    jellyfish_only = sum(1 for kmer in jellyfish if kmer not in ours)

    print("\n=== Comparison Results ===")
    print(f"krust_tpu_torch unique k-mers: {len(ours)}")
    print(f"Jellyfish unique k-mers: {len(jellyfish)}")
    print()
    if mismatches == 0 and ours_only == 0 and jellyfish_only == 0:
        print("PERFECT MATCH! All k-mer counts are identical.")
        return True
    print("Differences:")
    print(f"  Count mismatches:    {mismatches}")
    print(f"  Only in krust_tpu_torch: {ours_only}")
    print(f"  Only in Jellyfish:   {jellyfish_only}")
    return False


def print_summary(counts: dict[str, int]) -> None:
    total = sum(counts.values())
    max_count = max(counts.values(), default=0)
    print("\n=== K-mer Summary ===")
    print(f"Unique k-mers: {len(counts)}")
    print(f"Total k-mers:  {total}")
    print(f"Max count:     {max_count}")
    print("\nTop 5 k-mers:")
    ranked = sorted(counts.items(), key=lambda kv: (-kv[1], kv[0]))
    for kmer, count in ranked[:5]:
        print(f"  {kmer}: {count}")


def main() -> None:
    args = sys.argv[1:]
    if not args:
        prog = os.path.basename(sys.argv[0])
        print(f"Usage: {prog} <fasta_file> [k]", file=sys.stderr)
        print(file=sys.stderr)
        print("Counts k-mers and compares with Jellyfish if available.",
              file=sys.stderr)
        sys.exit(1)

    path = args[0]
    k = int(args[1]) if len(args) > 1 else 21

    print(f"Counting {k}-mers with krust_tpu_torch...", file=sys.stderr)
    try:
        ours = kt.count_kmers(path, k)
    except (KrustError, OSError) as e:
        print(f"Error: {e}", file=sys.stderr)
        sys.exit(1)
    print(f"krust_tpu_torch found {len(ours)} unique canonical k-mers",
          file=sys.stderr)

    theirs = run_jellyfish(path, k)
    if theirs is None:
        print("\nJellyfish not found. Install it to enable comparison:",
              file=sys.stderr)
        print("  macOS:  brew install jellyfish", file=sys.stderr)
        print("  Linux:  apt install jellyfish", file=sys.stderr)
        print("\nkrust_tpu_torch results only:", file=sys.stderr)
        print_summary(ours)
        return

    if not compare_counts(ours, theirs):
        sys.exit(1)


if __name__ == "__main__":
    main()
