"""Command-line entry points for the visualization formatters.

Counterparts of the reference's standalone scripts:
  sort_ntsynt_blocks.py         -> ntsynt-tpu-torch-sort-blocks
  format_blocks_gggenomes.py/.sh-> ntsynt-tpu-torch-gggenomes
  format_blocks_chromosome_painting.py -> ntsynt-tpu-torch-painting
plus plot rendering (replacing the R scripts) via --plot.
"""

import argparse
import os
import re
import sys

from . import formats


def sort_blocks_main(argv=None):
    parser = argparse.ArgumentParser(
        prog="ntsynt-tpu-torch-sort-blocks",
        description="Sort the assemblies within each synteny block into a given order",
    )
    parser.add_argument("--synteny_blocks", required=True)
    parser.add_argument("--sort_order", nargs="+", required=True)
    parser.add_argument(
        "--fais", action="store_true",
        help="sort_order lists the FAI files for the assemblies",
    )
    args = parser.parse_args(argv)
    order = args.sort_order
    if args.fais:
        order = [
            re.search(r"^(\S+)\.fai$", os.path.basename(os.path.realpath(f))).group(1)
            for f in order
        ]
    formats.sort_blocks(args.synteny_blocks, order, out=sys.stdout)
    return 0


def gggenomes_main(argv=None):
    parser = argparse.ArgumentParser(
        prog="ntsynt-tpu-torch-gggenomes",
        description="Format ntSynt-style blocks for ribbon visualization",
    )
    parser.add_argument("--fai", required=True, nargs="+")
    parser.add_argument("--blocks", required=True)
    parser.add_argument("-p", "--prefix", default="ntsynt_synteny_visuals")
    parser.add_argument("-l", "--length", type=int, default=10000, help="Minimum block length [10kb]")
    parser.add_argument("--colour", help="Assembly whose chromosome colours the links")
    parser.add_argument("--plot", help="Also render <prefix>.ribbon.png", action="store_true")
    args = parser.parse_args(argv)
    colour = args.colour or re.search(r"^(\S+)\.fai$", os.path.basename(args.fai[0])).group(1)
    seq = formats.write_sequence_lengths(args.fai, args.prefix)
    links = formats.write_links(args.blocks, args.prefix, args.length, colour)
    if args.plot:
        from .plot import ribbon_plot

        print(ribbon_plot(seq, links, f"{args.prefix}.ribbon.png"))
    return 0


def painting_main(argv=None):
    parser = argparse.ArgumentParser(
        prog="ntsynt-tpu-torch-painting",
        description="Re-express blocks relative to a target assembly for chromosome painting",
    )
    parser.add_argument("synteny_tsv")
    parser.add_argument("--target", required=True)
    parser.add_argument("--convert", help="TSV of assembly-name conversions")
    parser.add_argument("-o", "--output", default="painting.tsv")
    parser.add_argument("--plot", help="Also render <output>.png", action="store_true")
    args = parser.parse_args(argv)
    convert = None
    if args.convert:
        convert = {}
        with open(args.convert, "r", encoding="utf-8") as fin:
            for line in fin:
                a, b = line.rstrip("\n").split("\t")
                convert[a] = b
    out = formats.write_chromosome_painting(args.synteny_tsv, args.target, args.output, convert)
    if args.plot:
        from .plot import painting_plot

        print(painting_plot(out, f"{args.output}.png"))
    return 0
