"""ntsynt_tpu_torch command line interface.

Mirrors the reference driver's surface (bin/ntSynt:43-99) and the JAX
package's CLI: same flags and divergence->parameter presets, plus
``--device {cuda,cpu}``; the whole pipeline runs in-process on one
torch device (or, with ``--mesh``, on each rank of a process group:
parallel/multihost.py) instead of shelling out to snakemake.
"""

import argparse
import os
import sys

NTSYNT_TORCH_VERSION = "ntsynt-tpu-torch v0.1.0"

ASCII = r"""
        _    ____                 _          _
 _ __  | |_ / ___|  _   _  _ __  | |_       | |_  _ __   _   _
| '_ \ | __|\___ \ | | | || '_ \ | __| _____| __|| '_ \ | | | |
| | | || |_  ___) || |_| || | | || |_ |_____| |_ | |_) || |_| |
|_| |_| \__||____/  \__, ||_| |_| \__|       \__|| .__/  \__,_|
                    |___/                        |_|
"""


def read_fasta_list(filename):
    """--fastas_list file: one fasta path per line (bin/ntSynt:25-31)."""
    with open(filename, "r", encoding="utf-8") as fin:
        return [line.strip() for line in fin if line.strip()]


def apply_divergence_presets(args, parser):
    """Divergence -> default parameter mapping (bin/ntSynt:89-99)."""
    if args.divergence < 1:
        defaults = (10000, "10000", [100, 10], 500)
    elif 1 <= args.divergence <= 10:
        defaults = (50000, "100000", [250, 100], 1000)
    elif 10 < args.divergence <= 100:
        defaults = (100000, "1000000", [500, 250], 10000)
    else:
        parser.error("--divergence must be a value between 0 and 100")
    args.indel = args.indel or defaults[0]
    args.merge = args.merge or defaults[1]
    args.w_rounds = args.w_rounds or defaults[2]
    args.block_size = args.block_size or defaults[3]


def build_parser():
    epilog = "\n".join(
        [
            "Default parameter settings for divergence values:",
            "< 1% divergence:\t--block_size 500 --indel 10000 --merge 10000 --w_rounds 100 10",
            "1% - 10% divergence:\t--block_size 1000 --indel 50000 --merge 100000 --w_rounds 250 100",
            "> 10% divergence:\t--block_size 10000 --indel 100000 --merge 1000000 --w_rounds 500 250",
            "Manually set parameters override these presets.",
        ]
    )
    parser = argparse.ArgumentParser(
        prog="ntsynt-tpu-torch",
        description="ntsynt-tpu-torch: multi-genome synteny detection using minimizer graphs, "
        "on PyTorch and CUDA",
        formatter_class=argparse.RawTextHelpFormatter,
        epilog=epilog,
    )
    parser.add_argument("fastas", help="Input genome fasta files", nargs="*")
    parser.add_argument("--fastas_list", help="File listing input genome fasta files, one per line")
    parser.add_argument(
        "-d",
        "--divergence",
        help="Approx. maximum percent sequence divergence between input genomes",
        required=True,
        type=float,
    )
    parser.add_argument("-p", "--prefix", help="Prefix for output files [ntSynt.k<k>.w<w>]")
    parser.add_argument("-k", help="Minimizer k-mer size [24]", type=int, default=24)
    parser.add_argument("-w", help="Minimizer window size [1000]", type=int, default=1000)
    parser.add_argument(
        "-t", help="Host threads for the native FASTA reader [12]",
        type=int, default=12,
    )
    parser.add_argument("--fpr", help="Bloom filter false positive rate [0.025]", type=float, default=0.025)
    parser.add_argument("-b", "--block_size", help="Minimum synteny block size (bp)", type=int)
    parser.add_argument(
        "--merge",
        help="Maximum distance between collinear blocks for merging (bp or '<num>w')",
        type=str,
    )
    parser.add_argument(
        "--w_rounds", help="Decreasing window sizes for refinement", nargs="+", type=int
    )
    parser.add_argument("--indel", help="Threshold for indel detection (bp)", type=int)
    parser.add_argument("--no-common", help=argparse.SUPPRESS, action="store_true")
    parser.add_argument("--no-simplify-graph", help=argparse.SUPPRESS, action="store_true")
    # experimental repeat-BF path: the reference's bin/ntSynt hides it
    # (no repeat flag there; the .smk make_repeat_bf rule is
    # experimental and reached via bin/ntsynt_run.py:21 --filter)
    parser.add_argument(
        "--filter",
        dest="repeat_filter",
        choices=["Filter", "Indexlr"],
        help="Experimental: filter repetitive minimizers with a repeat "
        "Bloom filter, either at sketch time (Indexlr, like indexlr -r) "
        "or at load time (Filter)",
    )
    parser.add_argument("-n", "--dry-run", help="Print planned steps and exit", action="store_true")
    parser.add_argument("--benchmark", help="Record per-stage wall-clock timings", action="store_true")
    parser.add_argument("-f", "--force", help="Recompute all artifacts", action="store_true")
    parser.add_argument("--dev", help="Developer mode: verbose logs, extra artifacts", action="store_true")
    parser.add_argument(
        "--mesh",
        help="Shard Bloom-filter build + sketching over all ranks of the process group, "
        "or this one device when there is no group",
        action="store_true",
    )
    parser.add_argument(
        "--device", choices=["cuda", "cpu"], default="cuda",
        help="Torch device to compute on [cuda]; cuda raises when no GPU is present",
    )
    parser.add_argument("-v", "--version", action="version", version=NTSYNT_TORCH_VERSION)
    return parser


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    apply_divergence_presets(args, parser)

    for w in args.w_rounds:
        if w > args.w:
            parser.error("All values specified for --w_rounds must be smaller than -w")

    if not args.fastas and not args.fastas_list:
        parser.error(
            "Please supply the input genome fasta files as positional arguments, "
            "or specify a file listing them with --fastas_list"
        )
    if args.fastas and args.fastas_list:
        parser.error("Supply fastas positionally OR with --fastas_list, not both")
    fastas = read_fasta_list(args.fastas_list) if args.fastas_list else args.fastas
    if len(fastas) < 2:
        parser.error("Must supply at least two genomes to compare")
    for f in fastas:
        if not os.path.isfile(f):
            raise FileNotFoundError(f"Input file {f} not found.")

    print(ASCII)
    print("Running ntsynt-tpu-torch...")
    print(f"Specified percent divergence: {args.divergence}")
    print("Parameter settings:")
    for label, value in [
        ("fastas", fastas),
        ("--divergence", args.divergence),
        ("--block_size", args.block_size),
        ("--merge", args.merge),
        ("--w_rounds", args.w_rounds),
        ("--indel", args.indel),
        ("-p", args.prefix or f"ntSynt.k{args.k}.w{args.w}"),
        ("-k", args.k),
        ("-w", args.w),
        ("--fpr", args.fpr),
        ("--device", args.device),
    ]:
        print(f"\t{label} {value}")
    sys.stdout.flush()

    from .core.pipeline import NtSyntPipeline, PipelineConfig

    cfg = PipelineConfig(
        fastas=fastas,
        k=args.k,
        w=args.w,
        prefix=args.prefix,
        fpr=args.fpr,
        block_size=args.block_size,
        indel=args.indel,
        merge=str(args.merge),
        w_rounds=tuple(args.w_rounds),
        common=not args.no_common,
        repeat=args.repeat_filter is not None,
        repeat_filter=args.repeat_filter,
        simplify_graph=not args.no_simplify_graph,
        benchmark=args.benchmark,
        dev=args.dev,
        force=args.force,
        dry_run=args.dry_run,
        device=args.device,
        threads=args.t,
        use_mesh=args.mesh,
    )
    out = NtSyntPipeline(cfg).run()
    if out:
        print(f"Done ntsynt-tpu-torch! Final blocks: {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
