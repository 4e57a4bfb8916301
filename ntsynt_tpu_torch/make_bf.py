"""Standalone Bloom-filter CLIs.

Equivalents of the reference's two standalone BF tools, with the JAX
package's flags, echo and output containers, plus ``--device``:

  * ``ntsynt-tpu-torch-make-common-bf`` — cascading common-k-mer filter
    (src/ntsynt_make_common_bf.cpp:43-167): flags ``--genome ... -k
    --fpr -p --bf -t --format``; writes ``<prefix>.bf``.
  * ``ntsynt-tpu-torch-make-repeat-bf`` — k-mers with multiplicity >= 2
    within any single genome (bin/ntsynt_make_repeat_bfs.py:35-69):
    flags ``--genome ... -k --bf <N[BkMG]> --fpr -p -t --format``;
    writes ``<prefix>.bf``.

The device work lives in ops/bf_build; these wrappers parse arguments,
echo parameters, read the FASTAs and save the filter. ``-t`` controls
host FASTA-reader threads.
"""

from __future__ import annotations

import argparse
import re

from .io.fasta import read_fasta
from .ops import bf_build
from .utils.log import log

_UNITS = {"B": 1, "k": 10**3, "M": 10**6, "G": 10**9}
_FORMAT_HELP = (
    "Output container: btllib KmerBloomFilter v6 (loadable by the "
    "reference/btllib; default) or the native ntsynt_tpu container"
)


def parse_bf_size(text: str) -> int:
    """Parse ``<num><B|k|M|G>`` into bytes (bin/ntsynt_make_repeat_bfs.py:10-23)."""
    m = re.search(r"^(\d+)([BkMG])$", text)
    if not m:
        raise argparse.ArgumentTypeError(f"Invalid input value for --bf: {text}")
    return int(m.group(1)) * _UNITS[m.group(2)]


def _echo(pairs) -> None:
    print("Parameters:")
    for flag, value in pairs:
        print(f"\t\t{flag} {value}")


def _add_common_flags(parser) -> None:
    parser.add_argument("--format", choices=("btllib", "native"), default="btllib",
                        help=_FORMAT_HELP)
    parser.add_argument(
        "--device", choices=["cuda", "cpu"], default="cuda",
        help="Torch device to compute on [cuda]; cuda raises when no GPU is present",
    )


def common_main(argv=None) -> int:
    """Entry point mirroring ``ntsynt_make_common_bf``
    (src/ntsynt_make_common_bf.cpp:46-81)."""
    parser = argparse.ArgumentParser(
        "ntsynt-tpu-torch-make-common-bf",
        description="Cascading Bloom filter of k-mers common to all genomes",
    )
    parser.add_argument("--genome", nargs="+", required=True, help="Input genome file(s)")
    parser.add_argument("-k", type=int, required=True, help="k-mer size (bp)")
    parser.add_argument("--fpr", type=float, default=0.025,
                        help="False positive rate for Bloom filter")
    parser.add_argument("-p", default="common_bf", help="Prefix for output Bloom filter")
    parser.add_argument("--bf", type=int, default=None,
                        help="Bloom filter size in bytes (optional)")
    parser.add_argument("-t", type=int, default=12, help="Number of threads")
    _add_common_flags(parser)
    args = parser.parse_args(argv)

    _echo([("--genome", " ".join(args.genome)), ("-t", args.t), ("-k", args.k),
           ("--fpr", args.fpr), ("-p", args.p), ("--device", args.device)])
    # sorted so the output BF is identical regardless of argument order
    # (src/ntsynt_make_common_bf.cpp:105-107)
    genomes = [read_fasta(p, keep_raw=False, threads=args.t) for p in sorted(args.genome)]
    bf = bf_build.build_common_bf(genomes, args.k, fpr=args.fpr, bf_bytes=args.bf,
                                  device=args.device)
    out = bf.save(f"{args.p}.bf", fmt=args.format)
    log(f"Saved common Bloom filter to {out}")
    return 0


def repeat_main(argv=None) -> int:
    """Entry point mirroring ``ntsynt_make_repeat_bfs.py``
    (bin/ntsynt_make_repeat_bfs.py:35-69)."""
    parser = argparse.ArgumentParser(
        "ntsynt-tpu-torch-make-repeat-bf",
        description="Generating BF of k-mer 2+ multiplicities",
    )
    parser.add_argument("--genome", nargs="+", required=True, help="Input genome file(s)")
    parser.add_argument("-k", type=int, required=True, help="K-mer size (bp)")
    parser.add_argument("--bf", type=parse_bf_size, default=None,
                        help="Bloom filter size [accepted units: B (bytes), "
                        "k (kilobytes), M (megabytes), G (gigabytes)]")
    parser.add_argument("-t", type=int, default=4, help="Number of threads [4]")
    parser.add_argument("-p", default="out", help="Prefix for output BF")
    parser.add_argument("--fpr", type=float, default=0.01,
                        help="False positive rate for Bloom filter. "
                        "Only used if --bf is not specified. [0.01]")
    _add_common_flags(parser)
    args = parser.parse_args(argv)

    _echo([("--genome", " ".join(args.genome)), ("-t", args.t), ("-k", args.k),
           ("--bf", args.bf), ("--fpr", args.fpr), ("-p", args.p), ("--device", args.device)])
    genomes = [read_fasta(p, keep_raw=False, threads=args.t) for p in args.genome]
    bf = bf_build.build_repeat_bf(genomes, args.k, fpr=args.fpr, bf_bytes=args.bf,
                                  device=args.device)
    out = bf.save(f"{args.p}.bf", fmt=args.format)
    log(f"Saved repeat Bloom filter to {out}")
    return 0
