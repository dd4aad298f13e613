"""Command-line interface (reference: src/cli.rs, src/main.rs).

Same UX as the reference binary::

    kmix <k> [path] [-f fasta|tsv|json|histogram] [-m N] [-q]
             [-i auto|fasta|fastq] [--save PATH] [-Q N]
    kmix query <index.kmix> <KMER>

``-`` or an omitted path reads stdin. All informational output goes to
stderr; ``--quiet`` silences it entirely (the reference's stderr-empty
contract; reference: tests/integration_tests.rs:233-261). Errors exit 1.
"""

from __future__ import annotations

import argparse
import sys

from . import api, __version__
from .errors import KrustError
from .index import KmerIndex, load_index, save_index
from .io.format import SequenceFormat
from .io.input import Input
from .kmer import KmerLength, canonical_packed, pack
from .output import OutputFormat, output_packed
from .utils.tracing import init_tracing

_BOLD = "\033[1m"
_BLUE = "\033[34m"
_YELLOW = "\033[33m"
_GREEN = "\033[32m"
_UL = "\033[4m"
_RESET = "\033[0m"


def _style(text: str, *codes: str) -> str:
    if not sys.stderr.isatty():
        return text
    return "".join(codes) + text + _RESET


def _parse_k(value: str) -> int:
    try:
        k = int(value)
    except ValueError:
        raise argparse.ArgumentTypeError(f"'{value}' is not a valid number")
    if k == 0:
        raise argparse.ArgumentTypeError("k-mer length must be at least 1")
    if k < 0:
        raise argparse.ArgumentTypeError(f"'{value}' is not a valid number")
    if k > 32:
        raise argparse.ArgumentTypeError("k-mer length must be at most 32")
    return k


def _parse_min_count(value: str) -> int:
    """Non-negative count (the reference's clap u64 rejects negatives;
    reference: src/cli.rs:50)."""
    try:
        n = int(value)
    except ValueError:
        raise argparse.ArgumentTypeError(f"'{value}' is not a valid number")
    if n < 0:
        raise argparse.ArgumentTypeError(f"'{value}' is not a valid number")
    return n


def _count_parser(prog: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog=prog,
        description=(
            "A fast, GPU-parallel k-mer counter for DNA sequences in FASTA "
            "and FASTQ files."
        ),
    )
    p.add_argument("--version", action="version", version=f"{prog} {__version__}")
    p.add_argument("k", type=_parse_k, help="K-mer length (1-32)")
    p.add_argument(
        "path", nargs="?", default="-",
        help="Input file path (use '-' or omit for stdin)",
    )
    p.add_argument(
        "-f", "--format", choices=[f.value for f in OutputFormat],
        default="fasta", help="Output format",
    )
    p.add_argument(
        "-m", "--min-count", type=_parse_min_count, default=1,
        help="Minimum count threshold (k-mers below this are excluded)",
    )
    p.add_argument(
        "-q", "--quiet", action="store_true",
        help="Suppress informational output (only output k-mer counts)",
    )
    p.add_argument(
        "-i", "--input-format", choices=[f.value for f in SequenceFormat],
        default="auto",
        help="Input file format (auto-detected from extension if not specified)",
    )
    p.add_argument(
        "--save", metavar="PATH", default=None,
        help="Save k-mer counts to index file for later querying",
    )
    p.add_argument(
        "-Q", "--min-quality", type=int, default=None, metavar="N",
        help="Minimum base quality (Phred, 0-93) for FASTQ filtering; "
        "k-mers containing bases below this threshold are skipped. "
        "Ignored for FASTA input.",
    )
    return p


def _query_parser(prog: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog=f"{prog} query",
        description="Query k-mer counts from a pre-built index",
    )
    p.add_argument("index", help="Path to the k-mer index file (.kmix)")
    p.add_argument("kmer", help="K-mer sequence to query (e.g., ACGTACGT)")
    return p


def _fail(title: str, detail: str) -> "None":
    print(_style(f"{title}", _BLUE, _BOLD), file=sys.stderr)
    print(_style(f" {detail}", _BLUE), file=sys.stderr)
    raise SystemExit(1)


def run_count(args: argparse.Namespace) -> None:
    input_ = Input.from_path(args.path)
    out_format = OutputFormat(args.format)
    in_format = SequenceFormat(args.input_format)

    if args.min_quality is not None and not 0 <= args.min_quality <= 93:
        _fail("Problem with arguments:", "min-quality must be between 0 and 93")

    if input_.is_file and not input_.path.exists():
        _fail("Problem with arguments:", f"File not found: {input_.path}")

    resolved = in_format.resolve(input_.path if input_.is_file else None)

    if not args.quiet:
        banner = sys.stderr
        print(f"{_style('k-length', _BOLD)}: {_style(str(args.k), _BLUE, _BOLD)}", file=banner)
        print(f"{_style('data', _BOLD)}: {_style(str(input_), _UL, _BOLD, _BLUE)}", file=banner)
        fmt_disp = (
            f"{resolved} (auto-detected)"
            if in_format is SequenceFormat.AUTO
            else str(in_format)
        )
        print(f"{_style('input-format', _BOLD)}: {_style(fmt_disp, _BLUE, _BOLD)}", file=banner)
        print(f"{_style('reader', _BOLD)}: {_style('krust-tpu-torch', _BLUE, _BOLD)}", file=banner)
        print(f"{_style('output-format', _BOLD)}: {_style(out_format.value, _BLUE, _BOLD)}", file=banner)
        if args.min_count > 1:
            print(f"{_style('min-count', _BOLD)}: {_style(str(args.min_count), _BLUE, _BOLD)}", file=banner)
        if args.min_quality is not None:
            print(f"{_style('min-quality', _BOLD)}: {_style(str(args.min_quality), _BLUE, _BOLD)}", file=banner)
        if args.save is not None:
            print(f"{_style('save-index', _BOLD)}: {_style(args.save, _BLUE, _BOLD)}", file=banner)
        print(file=banner)

    if args.min_quality is not None and resolved.is_fasta and not args.quiet:
        print(
            f"{_style('warning', _YELLOW, _BOLD)}: "
            f"{_style('--min-quality is ignored for FASTA input', _YELLOW)}",
            file=sys.stderr,
        )
    if args.min_quality is not None and input_.is_stdin and not args.quiet:
        print(
            f"{_style('warning', _YELLOW, _BOLD)}: "
            f"{_style('--min-quality is not yet supported for stdin input', _YELLOW)}",
            file=sys.stderr,
        )

    try:
        result = api.count_with_input(input_, args.k, resolved, args.min_quality)
    except FileNotFoundError as e:
        _fail("Application error:", str(e))
        return
    except KrustError as e:
        _fail("Application error:", str(e))
        return

    if args.save is not None:
        index = KmerIndex.from_arrays(KmerLength(args.k), result.codes, result.counts)
        try:
            save_index(index, args.save)
        except KrustError as e:
            _fail("Failed to save index:", str(e))
            return
        if not args.quiet:
            print(
                f"{_style('saved', _BOLD)}: "
                f"{_style(args.save, _GREEN, _BOLD)} ({len(index)} k-mers)",
                file=sys.stderr,
            )

    output_packed(result, out_format, args.min_count)


def run_query(args: argparse.Namespace) -> None:
    try:
        index = load_index(args.index)
    except (KrustError, FileNotFoundError, OSError) as e:
        _fail("Failed to load index:", str(e))
        return

    kmer_str = args.kmer.upper()
    if len(kmer_str) != index.k.get():
        _fail(
            "Query error:",
            f"k-mer length mismatch: query has {len(kmer_str)} bases, "
            f"index has k={index.k.get()}",
        )
        return

    try:
        packed = pack(kmer_str)
    except KrustError as e:
        _fail("Invalid k-mer:", str(e))
        return

    canonical, _ = canonical_packed(packed, index.k)
    count = index.get(canonical)
    print(count if count is not None else 0)


def main(argv: list[str] | None = None) -> int:
    init_tracing()
    argv = list(sys.argv[1:] if argv is None else argv)
    prog = "kmix"

    # subcommand sniffing, like the reference (reference: src/main.rs:38-52)
    if argv[:1] == ["query"]:
        args = _query_parser(prog).parse_args(argv[1:])
        run_query(args)
        return 0

    args = _count_parser(prog).parse_args(argv)
    run_count(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
