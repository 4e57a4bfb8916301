"""Core synteny stage CLI: minimizer TSVs in, synteny blocks out.

Mirrors the reference's inner entry point bin/ntsynt_run.py:10-50 and
the JAX package's ``ntsynt-tpu-run``: re-runs the graph and refinement
stages on existing sketches (e.g. the reference's own .k<k>.w<w>.tsv
artifacts) without re-sketching. Refinement rounds need the genome
sequences, supplied with --fastas, and re-sketch on ``--device``.
"""

import argparse
import os
import re
import sys

from . import resolve_device
from .core.assembly import AssemblyMinimizers
from .core.synteny import SyntenyDetector, SyntenyParams
from .io import read_fasta, read_sketch_tsv
from .ops.bloom import load_bf
from .ops.nthash import unmix_np


def build_parser():
    parser = argparse.ArgumentParser(
        prog="ntsynt-tpu-torch-run",
        description="Run the dynamic minimizer graph stage of ntsynt-tpu-torch",
    )
    parser.add_argument("FILES", nargs="+", help="Minimizer TSV files of input assemblies")
    parser.add_argument("--fastas", nargs="+", required=True, help="Assembly fasta files")
    parser.add_argument("-n", help="Minimum edge weight [#assemblies]", default=0, type=int)
    parser.add_argument("-p", help="Output prefix [out]", default="out", type=str)
    parser.add_argument("-k", help="k-mer size used for minimizer step", required=True, type=int)
    parser.add_argument("-w", help="window size used for minimizers", required=True, type=int)
    parser.add_argument("-z", help="Minimum synteny block size (bp) [500]", type=int, default=500)
    parser.add_argument(
        "--filter", help="Type of repeat filtering", choices=["Filter", "Indexlr"], type=str
    )
    parser.add_argument("--common", help="Common-kmer BF for minimizer selection", type=str)
    parser.add_argument(
        "--repeat", help="Repeat BF (must be included if --filter is specified)", type=str
    )
    parser.add_argument(
        "--btllib_t",
        help="Number of host threads for reading fasta files [4]",
        type=int,
        default=4,
    )
    parser.add_argument("--w-rounds", dest="w_rounds", default=[100, 10], nargs="+", type=int)
    parser.add_argument("--bp", help="Maximum tolerated indel size [500]", default=500, type=int)
    parser.add_argument(
        "--collinear-merge", dest="collinear_merge", default="1w", type=str,
        help="Max distance between collinear blocks for merging (bp or '<num>w') [1w]",
    )
    parser.add_argument("--simplify-graph", dest="simplify_graph", action="store_true")
    parser.add_argument("-m", help="Orientation vote threshold percent [90]", default=90, type=int)
    parser.add_argument("--dev", action="store_true")
    parser.add_argument("--interarrivals", action="store_true")
    parser.add_argument(
        "--device", choices=["cuda", "cpu"], default="cuda",
        help="Torch device to compute on [cuda]; cuda raises when no GPU is present",
    )
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.filter and not args.repeat:
        raise ValueError(
            "If --filter is specified, must supply repeat Bloom filter with --repeat"
        )
    device = resolve_device(args.device)
    fasta_by_base = {os.path.basename(f): f for f in args.fastas}

    repeat_bf = load_bf(args.repeat, device=device) if args.repeat else None
    # --filter Filter: drop TSV minimizers whose k-mer is in the repeat
    # BF at load time (load_minimizers(repeat_bf), bin/ntsynt_synteny.py:
    # 604-607); the BF key is the canonical hash, recovered from the
    # printed hash through the invertible mix (ops/nthash.unmix_np)
    rep_filter = None
    if args.filter == "Filter" and repeat_bf is not None:
        rep_filter = lambda out_hashes: repeat_bf.probe_np(unmix_np(out_hashes, args.k))

    assemblies = {}
    for tsv in args.FILES:
        base = os.path.basename(tsv)
        # strip .k<k>.w<w>.tsv to find the fasta (find_fa_name contract,
        # bin/ntsynt_synteny.py:108-115)
        m = re.search(r"^(\S+)\.k\d+\.w\d+\.tsv$", base)
        if not m:
            print(
                "ERROR: minimizer TSV files must be named "
                "<assembly>.k<k>.w<w>.tsv",
                file=sys.stderr,
            )
            return 1
        fa_name = m.group(1)
        genome = None
        if fa_name in fasta_by_base:
            genome = read_fasta(fasta_by_base[fa_name], threads=args.btllib_t)
        records = read_sketch_tsv(tsv)
        assemblies[fa_name] = AssemblyMinimizers.from_tsv_records(
            fa_name, records, genome=genome, repeat_out_filter=rep_filter
        )

    common_bf = load_bf(args.common, device=device) if args.common else None
    params = SyntenyParams(
        k=args.k,
        w=args.w,
        n=args.n,
        m=float(args.m),
        z=args.z,
        bp=args.bp,
        collinear_merge=args.collinear_merge,
        w_rounds=tuple(args.w_rounds),
        simplify_graph=args.simplify_graph,
        repeat_filter=args.filter,
        dev=args.dev,
        interarrivals=args.interarrivals,
        prefix=args.p,
        common_bf=common_bf,
        repeat_bf=repeat_bf,
        device=str(device),
    )
    out = SyntenyDetector(assemblies, params).run()
    print(f"Final synteny blocks: {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
