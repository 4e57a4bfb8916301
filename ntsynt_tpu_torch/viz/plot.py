"""Synteny plots (matplotlib replaces the reference's R scripts).

  * ribbon_plot   — gggenomes-style ribbon diagram
                    (plot_synteny_blocks_gggenomes.R)
  * painting_plot — chromosome-painting segments, orientation encoded by
                    a +/-0.1 vertical nudge
                    (plot_synteny_blocks-chromosome-painting.R:43-66)

Both consume the TSVs produced by viz/formats.py.
"""

import csv
from collections import OrderedDict


def _load_tsv(path):
    with open(path, "r", encoding="utf-8") as fin:
        return list(csv.DictReader(fin, delimiter="\t"))


def ribbon_plot(sequence_lengths_tsv: str, links_tsv: str, out_png: str, scale: float = 1e6):
    """Draw stacked assemblies with ribbons between linked blocks."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.patches import Polygon

    seqs = _load_tsv(sequence_lengths_tsv)
    links = _load_tsv(links_tsv)

    bins = OrderedDict()
    for row in seqs:
        bins.setdefault(row["bin_id"], []).append((row["seq_id"], int(row["length"])))
    y_of = {b: -i for i, b in enumerate(bins)}
    offsets = {}
    for b, contigs in bins.items():
        x = 0
        for name, length in contigs:
            offsets[(b, name)] = x
            x += length + length * 0.02

    fig, ax = plt.subplots(figsize=(12, 1.8 * len(bins) + 1))
    for b, contigs in bins.items():
        for name, length in contigs:
            x0 = offsets[(b, name)] / scale
            ax.plot([x0, x0 + length / scale], [y_of[b]] * 2, lw=6, color="#404040",
                    solid_capstyle="butt", zorder=3)

    chroms = sorted({l["colour_block"] for l in links})
    cmap = matplotlib.colormaps["tab20"].resampled(max(len(chroms), 1))
    colour = {c: cmap(i) for i, c in enumerate(chroms)}
    for l in links:
        try:
            x1a = (offsets[(l["bin_id"], l["seq_id"])] + int(l["start"])) / scale
            x1b = (offsets[(l["bin_id"], l["seq_id"])] + int(l["end"])) / scale
            x2a = (offsets[(l["bin_id2"], l["seq_id2"])] + int(l["start2"])) / scale
            x2b = (offsets[(l["bin_id2"], l["seq_id2"])] + int(l["end2"])) / scale
        except KeyError:
            continue
        y1, y2 = y_of[l["bin_id"]] - 0.05, y_of[l["bin_id2"]] + 0.05
        if l["strand"] == "-":
            x2a, x2b = x2b, x2a
        ax.add_patch(
            Polygon(
                [(x1a, y1), (x1b, y1), (x2b, y2), (x2a, y2)],
                closed=True,
                facecolor=colour.get(l["colour_block"], "#888888"),
                alpha=0.45,
                edgecolor="none",
                zorder=2,
            )
        )
    ax.set_yticks([y_of[b] for b in bins])
    ax.set_yticklabels(list(bins))
    ax.set_xlabel(f"Position ({'Mbp' if scale == 1e6 else 'bp'})")
    ax.set_ylim(min(y_of.values()) - 0.6, 0.6)
    for side in ("top", "right", "left"):
        ax.spines[side].set_visible(False)
    fig.tight_layout()
    fig.savefig(out_png, dpi=150)
    plt.close(fig)
    return out_png


def painting_plot(painting_tsv: str, out_png: str, scale: float = 1e6):
    """Chromosome painting: target chromosomes as rows, other-species
    segments coloured by their chromosome; inverted segments nudged."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    rows = _load_tsv(painting_tsv)
    chrom_rows = OrderedDict()
    for r in rows:
        chrom_rows.setdefault(r["target_chrom"], []).append(r)
    others = sorted({r["other_species"] for r in rows})
    o_idx = {o: i for i, o in enumerate(others)}
    other_chroms = sorted({r["other_chrom"] for r in rows})
    cmap = matplotlib.colormaps["tab20"].resampled(max(len(other_chroms), 1))
    colour = {c: cmap(i) for i, c in enumerate(other_chroms)}

    n_lanes = max(len(others), 1)
    fig, axes = plt.subplots(
        len(chrom_rows), 1, figsize=(12, 1.2 * n_lanes * len(chrom_rows) + 1), squeeze=False
    )
    for ax, (chrom, rws) in zip(axes[:, 0], chrom_rows.items()):
        for r in rws:
            lane = o_idx[r["other_species"]]
            nudge = 0.1 if r["relative_ori"] == "+" else -0.1
            ax.plot(
                [int(r["target_start"]) / scale, int(r["target_end"]) / scale],
                [lane + nudge] * 2,
                lw=8,
                color=colour[r["other_chrom"]],
                solid_capstyle="butt",
            )
        ax.set_yticks(range(len(others)))
        ax.set_yticklabels(others)
        ax.set_title(chrom, fontsize=9, loc="left")
        ax.set_ylim(-0.6, len(others) - 0.4)
    axes[-1, 0].set_xlabel(f"Position ({'Mbp' if scale == 1e6 else 'bp'})")
    fig.tight_layout()
    fig.savefig(out_png, dpi=150)
    plt.close(fig)
    return out_png
