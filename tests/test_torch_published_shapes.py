"""The port (--device cpu) against the JAX package on the N-genome paths:
five and eleven genomes, and a common filter at the occupancy of the
2^34-bit cap at 2 x 3 Gbp (the presets: tests/test_torch_presets.py).

Each scenario runs the same FASTAs through the JAX package's CLI (or
NtSyntTPU) and the port's CLI (or NtSyntPipeline); every artifact must
be byte-identical. Tolerance 0."""

import os

import numpy as np
import pytest

from ntsynt_tpu.cli import main as jax_main
from ntsynt_tpu.core.pipeline import NtSyntTPU, PipelineConfig as JaxConfig
from ntsynt_tpu.ops.bloom import load_bf as jax_load_bf
from ntsynt_tpu_torch.cli import main as torch_main
from ntsynt_tpu_torch.core.pipeline import NtSyntPipeline, PipelineConfig
from ntsynt_tpu_torch.ops.bloom import load_bf

DEC = np.array(list("ACGT"))
ARGS = ["-k", "24", "-w", "100", "--w_rounds", "50", "10", "-b", "500", "--indel", "500",
        "--merge", "3000"]  # tests/test_e2e.py's _cfg


def write_fasta(path, contigs):
    with open(path, "w") as f:
        for name, codes in contigs:
            f.write(f">{name}\n")
            s = "".join(DEC[codes])
            f.write("\n".join(s[i : i + 70] for i in range(0, len(s), 70)) + "\n")
    return str(path)


def mutate(rng, g, rate):
    g = g.copy()
    snp = rng.random(len(g)) < rate
    g[snp] = (g[snp] + rng.integers(1, 4, int(snp.sum()))) % 4
    return g


def _files(work):
    return {f: (work / f).read_bytes() for f in sorted(os.listdir(work))}


def _run_both(tmp_path, fastas, monkeypatch, args):
    """Both CLIs on the same FASTAs, each from its own working directory;
    returns ({file: bytes} of the JAX run, of the port's)."""
    outs = {}
    for name, fn, more in (("jax", jax_main, []), ("torch", torch_main, ["--device", "cpu"])):
        work = tmp_path / name
        work.mkdir()
        monkeypatch.chdir(work)
        assert fn([*fastas, *args, "-p", "test", *more]) == 0
        outs[name] = _files(work)
    return outs["jax"], outs["torch"]


def _assert_same(j, t):
    assert sorted(j) == sorted(t)
    assert "test.synteny_blocks.tsv" in j
    for f in j:
        assert j[f] == t[f], f"{f} differs"


def _rows(data: bytes):
    return [line.split("\t") for line in data.decode().splitlines()]


@pytest.fixture(scope="module")
def base_genome():
    rng = np.random.default_rng(1234)  # tests/test_e2e.py's base genome
    return rng.integers(0, 4, 200_000).astype(np.uint8)


def test_five_genomes_known_inversion(tmp_path, base_genome, monkeypatch):
    """tests/test_e2e.py::test_five_genomes_known_inversion's five
    genomes (private SNPs, n2 inverted at 80-130 kb)."""
    rng = np.random.default_rng(55)
    fastas = []
    for gi in range(5):
        g = base_genome.copy()
        if gi > 0:
            g = mutate(rng, g, 0.0005)
        if gi == 2:
            g[80_000:130_000] = g[80_000:130_000][::-1] ^ 3
        fastas.append(write_fasta(tmp_path / f"n{gi}.fa", [("chr1", g)]))
    j, t = _run_both(tmp_path, fastas, monkeypatch, ["-d", "1", *ARGS])
    _assert_same(j, t)
    rows = _rows(t["test.synteny_blocks.tsv"])
    assert len({r[0] for r in rows}) == 3 and len(rows) == 15


def test_eleven_genomes_known_inversion(tmp_path, monkeypatch):
    """Eleven genomes of 200 kb (the 11-bee shape at CI size): eleven
    cascade levels and eleven rows a block; genome 3 inverted at
    70-120 kb."""
    rng = np.random.default_rng(1111)
    base = rng.integers(0, 4, 200_000).astype(np.uint8)
    fastas = []
    for gi in range(11):
        g = base if gi == 0 else mutate(rng, base, 0.001)
        if gi == 3:
            g[70_000:120_000] = g[70_000:120_000][::-1] ^ 3
        fastas.append(write_fasta(tmp_path / f"e{gi:02d}.fa", [("chr1", g)]))
    j, t = _run_both(tmp_path, fastas, monkeypatch, ["-d", "1", *ARGS])
    _assert_same(j, t)
    rows = _rows(t["test.synteny_blocks.tsv"])
    ids = {r[0] for r in rows}
    assert len(ids) == 3 and len(rows) == 33
    for i in ids:
        assert len({r[6] for r in rows if r[0] == i}) == 1  # one minimizer count a block
    # the middle block: e03 alone runs against the others
    oris = {r[1]: r[5] for r in rows if r[0] == sorted(ids, key=int)[1]}
    assert oris["e03.fa"] != oris["e00.fa"]
    assert len({o for a, o in oris.items() if a != "e03.fa"}) == 1


def test_capped_filter_occupancy(tmp_path):
    """tests/test_e2e.py::test_capped_bf_block_quality's pair with
    bf_bytes = 2^18 (200 kb into 2^21 bits: occupancy about 0.09, the
    capped multi-Gbp regime): byte-complete .bf files, the same popcount
    in both packages' filters, and every other artifact identical."""
    rng = np.random.default_rng(88)
    base = rng.integers(0, 4, 200_000).astype(np.uint8)
    mut = base.copy()
    mut[60_000:90_000] = mut[60_000:90_000][::-1] ^ 3
    snp = rng.random(len(mut)) < 0.001
    mut[snp] = (mut[snp] + rng.integers(1, 4, int(snp.sum()))) % 4
    fastas = [write_fasta(tmp_path / "cA.fa", [("chr1", base)]),
              write_fasta(tmp_path / "cB.fa", [("chr1", mut)])]
    kw = dict(k=24, w=100, w_rounds=(50, 10), block_size=500, indel=500, merge="3000",
              prefix="capped", bf_bytes=1 << 18, bf_artifact="full")
    outs = {}
    for name, cls, cfg in (
            ("jax", NtSyntTPU, JaxConfig(fastas=fastas, out_dir=str(tmp_path / "jax"), **kw)),
            ("torch", NtSyntPipeline,
             PipelineConfig(fastas=fastas, out_dir=str(tmp_path / "torch"), device="cpu", **kw))):
        os.makedirs(cfg.out_dir)
        cls(cfg).run()
        outs[name] = _files(tmp_path / name)
    assert sorted(outs["jax"]) == sorted(outs["torch"])
    for f, data in outs["jax"].items():
        assert outs["torch"][f] == data, f"{f} differs"
    jbf = jax_load_bf(str(tmp_path / "jax" / "capped.common.bf"))
    tbf = load_bf(str(tmp_path / "torch" / "capped.common.bf"), device="cpu")
    jpop = int(np.unpackbits(np.asarray(jbf.words).view(np.uint8)).sum())
    assert tbf.num_bits == jbf.num_bits == 1 << 21
    assert tbf.popcount() == jpop
    assert 0.05 < jpop / jbf.num_bits < 0.12
    rows = [r for r in _rows(outs["torch"]["capped.synteny_blocks.tsv"])
            if r[1] == "cB.fa" and r[5] == "-"]
    assert len(rows) == 1
