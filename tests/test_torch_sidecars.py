"""The port's sidecars (analysis/stats.py and viz/) against the JAX
package's, byte for byte: every formatter's output, the stats, and the
stdout and files of the console entry points, on tests/test_sidecars.py's
blocks TSV, on its streaming-semantics TSV and on a blocks TSV written
by the port's CLI (--device cpu). The plots: both packages write PNGs
of the same pixel size."""

import os
import struct

import numpy as np
import pytest

from ntsynt_tpu.analysis import stats as jax_stats
from ntsynt_tpu.viz import cli as jax_viz_cli
from ntsynt_tpu.viz import formats as jax_formats
from ntsynt_tpu_torch.analysis import stats as torch_stats
from ntsynt_tpu_torch.cli import main as torch_main
from ntsynt_tpu_torch.viz import cli as torch_viz_cli
from ntsynt_tpu_torch.viz import formats as torch_formats

# tests/test_sidecars.py's inputs
BLOCKS = """0\ta.fa\tchr1\t0\t50000\t+\t100\tNone
0\tb.fa\tchr1\t0\t50000\t+\t100\tNone
1\ta.fa\tchr1\t60000\t90000\t+\t60\tindel
1\tb.fa\tchr1\t61000\t91000\t-\t60\tindel
2\ta.fa\tchr2\t0\t5000\t+\t10\tid_change
2\tb.fa\tchr2\t0\t5000\t+\t10\tid_change
"""
STREAMING = (
    "0\ta.fa\tchrX\t0\t50000\t+\n"
    "0\tb.fa\tchr1\t0\t50000\t+\n"
    "1\tb.fa\tchr2\t0\t50000\t+\n"
    "1\tc.fa\tchr2\t0\t50000\t+\n"
    "2\tb.fa\tchr3\t0\t50000\t-\n"
    "2\tc.fa\tchr3\t0\t50000\t+\n"
    "3\tb.fa\tchr4\t0\t50000\t+\n"
    "3\tc.fa\tchr4\t0\t50000\t-\n"
)
FAIS = {"a.fa": [("chr1", 100000), ("chr2", 6000), ("chrX", 60000)],
        "b.fa": [("chr1", 101000), ("chr2", 6000), ("chr3", 60000), ("chr4", 60000)],
        "c.fa": [("chr2", 70000), ("chr3", 60000), ("chr4", 60000)]}
DEC = np.array(list("ACGT"))


def _write_fasta(path, contigs):
    with open(path, "w") as f:
        for name, codes in contigs:
            s = "".join(DEC[codes])
            f.write(f">{name}\n" + "\n".join(s[i : i + 70] for i in range(0, len(s), 70)) + "\n")
    return str(path)


@pytest.fixture(scope="module")
def cli_blocks(tmp_path_factory):
    """Three two-chromosome genomes (an inversion in b, a translocated
    piece in c) through the port's CLI on the CPU: its blocks TSV and
    .fai files."""
    work = tmp_path_factory.mktemp("torch_sidecar_cli")
    rng = np.random.default_rng(21)
    c1 = rng.integers(0, 4, 120_000).astype(np.uint8)
    c2 = rng.integers(0, 4, 80_000).astype(np.uint8)
    b1 = c1.copy()
    b1[30_000:70_000] = b1[30_000:70_000][::-1] ^ 3
    fastas = [
        _write_fasta(work / "ga.fa", [("chr1", c1), ("chr2", c2)]),
        _write_fasta(work / "gb.fa", [("chr1", b1), ("chr2", c2)]),
        _write_fasta(work / "gc.fa", [("chr1", np.concatenate([c1[:90_000], c2[:40_000]])),
                                      ("chr2", np.concatenate([c2[40_000:], c1[90_000:]]))]),
    ]
    cwd = os.getcwd()
    os.chdir(work)
    try:
        assert torch_main([*fastas, "-d", "1", "-k", "24", "-w", "100", "--w_rounds", "50", "10",
                           "-b", "500", "--indel", "500", "--merge", "3000", "-p", "sc",
                           "--device", "cpu"]) == 0
    finally:
        os.chdir(cwd)
    tsv = work / "sc.synteny_blocks.tsv"
    assert tsv.read_text().count("\n") >= 6
    return str(tsv), [str(work / f"g{x}.fa.fai") for x in "abc"], ["ga.fa", "gb.fa", "gc.fa"]


@pytest.fixture(params=["test_sidecars", "streaming", "port_cli"])
def inputs(request, tmp_path):
    """(blocks TSV, .fai paths, assembly names) of each input."""
    if request.param == "port_cli":
        return request.getfixturevalue("cli_blocks")
    tsv = tmp_path / "blocks.tsv"
    tsv.write_text(BLOCKS if request.param == "test_sidecars" else STREAMING)
    names = ["a.fa", "b.fa"] if request.param == "test_sidecars" else ["a.fa", "b.fa", "c.fa"]
    fais = []
    for name in names:
        path = tmp_path / f"{name}.fai"
        path.write_text("".join(f"{c}\t{ln}\t0\t70\t71\n" for c, ln in FAIS[name]))
        fais.append(str(path))
    return str(tsv), fais, names


def _read(path) -> bytes:
    with open(path, "rb") as fin:
        return fin.read()


def test_stats_identical(inputs):
    tsv, fais, _ = inputs
    assert torch_stats.compute_stats(tsv, fais) == jax_stats.compute_stats(tsv, fais)


def test_formatters_identical(inputs, tmp_path):
    tsv, fais, names = inputs
    for order in (names, names[::-1]):
        assert torch_formats.sort_blocks(tsv, order) == jax_formats.sort_blocks(tsv, order)
    outs = {}
    for pkg, fm in (("jax", jax_formats), ("torch", torch_formats)):
        d = tmp_path / pkg
        d.mkdir()
        files = [fm.write_sequence_lengths(fais, str(d / "v"))]
        for min_len in (1000, 10000, 40000):
            for colour in (None, names[-1]):
                files.append(fm.write_links(tsv, str(d / f"l{min_len}{colour}"), min_len,
                                            colour))
        for target in names:
            files.append(fm.write_chromosome_painting(tsv, target, str(d / f"p_{target}.tsv")))
        files.append(fm.write_chromosome_painting(tsv, names[0], str(d / "conv.tsv"),
                                                  {n: n.upper() for n in names}))
        outs[pkg] = {os.path.basename(f): _read(f) for f in files}
    assert outs["jax"] == outs["torch"]
    assert all(outs["torch"].values())


def _run_clis(stats_mod, viz_cli, tsv, fais, names, work, capsys):
    """Every console entry point from work: {label: stdout or file bytes}."""
    os.makedirs(work)
    conv = os.path.join(work, "conv.tsv")
    with open(conv, "w") as fout:
        fout.write("".join(f"{n}\t{n.upper()}\n" for n in names))
    cwd = os.getcwd()
    os.chdir(work)
    out = {}
    try:
        capsys.readouterr()
        stats_mod.main(["--tsv", tsv, "--fai", *fais])
        out["stats"] = capsys.readouterr().out
        assert viz_cli.sort_blocks_main(["--synteny_blocks", tsv, "--sort_order",
                                         *names[::-1]]) == 0
        out["sort"] = capsys.readouterr().out
        assert viz_cli.sort_blocks_main(["--synteny_blocks", tsv, "--sort_order", *fais,
                                         "--fais"]) == 0
        out["sort_fais"] = capsys.readouterr().out
        assert viz_cli.gggenomes_main(["--fai", *fais, "--blocks", tsv, "-p", "gv",
                                       "-l", "1000"]) == 0
        assert viz_cli.gggenomes_main(["--fai", *fais, "--blocks", tsv, "-p", "gc",
                                       "--colour", names[-1]]) == 0
        assert viz_cli.painting_main([tsv, "--target", names[0], "-o", "pt.tsv",
                                      "--convert", conv]) == 0
        out["stdout"] = capsys.readouterr().out
    finally:
        os.chdir(cwd)
    for f in sorted(os.listdir(work)):
        out[f] = _read(os.path.join(work, f))
    return out


def test_console_entry_points_identical(inputs, tmp_path, capsys):
    tsv, fais, names = inputs
    j = _run_clis(jax_stats, jax_viz_cli, tsv, fais, names, str(tmp_path / "jax"), capsys)
    t = _run_clis(torch_stats, torch_viz_cli, tsv, fais, names, str(tmp_path / "torch"), capsys)
    assert j == t
    assert {"gv.links.tsv", "gv.sequence_lengths.tsv", "gc.links.tsv", "pt.tsv"} <= set(t)
    assert t["stats"].startswith("Number_blocks\t")


def _png_size(path):
    with open(path, "rb") as fin:
        head = fin.read(24)
    assert head[:8] == b"\x89PNG\r\n\x1a\n"
    return struct.unpack(">II", head[16:24])


def test_plots_same_pixel_size(inputs, tmp_path, capsys):
    pytest.importorskip("matplotlib")
    tsv, fais, names = inputs
    sizes = {}
    for pkg, viz_cli in (("jax", jax_viz_cli), ("torch", torch_viz_cli)):
        d = tmp_path / pkg
        d.mkdir()
        assert viz_cli.gggenomes_main(["--fai", *fais, "--blocks", tsv, "-p", str(d / "gv"),
                                       "-l", "1000", "--plot"]) == 0
        assert viz_cli.painting_main([tsv, "--target", names[-1], "-o", str(d / "pt.tsv"),
                                      "--plot"]) == 0
        sizes[pkg] = [_png_size(d / f) for f in ("gv.ribbon.png", "pt.tsv.png")]
    assert capsys.readouterr().out.count(".png") == 4
    assert sizes["jax"] == sizes["torch"]
