"""The port's CLI (--device cpu) against the JAX package's CLI on the
remaining tests/test_e2e.py scenarios: translocation, insertion,
--no-common, dry run and artifacts, and sketch-artifact reuse. Every
artifact must be byte-identical (the per-stage timings of --benchmark
excepted, whose stage names must agree)."""

import os

import numpy as np
import pytest

from ntsynt_tpu.cli import main as jax_main
from ntsynt_tpu.core.pipeline import NtSyntTPU, PipelineConfig as JaxConfig
from ntsynt_tpu_torch.cli import main as torch_main
from ntsynt_tpu_torch.core.pipeline import NtSyntPipeline, PipelineConfig

DEC = np.array(list("ACGT"))
ARGS = ["-d", "1", "-k", "24", "-w", "100", "--w_rounds", "50", "10", "-b", "500",
        "--indel", "500", "--merge", "3000", "-p", "test"]


def write_fasta(path, contigs):
    with open(path, "w") as f:
        for name, codes in contigs:
            f.write(f">{name}\n")
            s = "".join(DEC[codes])
            f.write("\n".join(s[i : i + 70] for i in range(0, len(s), 70)) + "\n")
    return str(path)


@pytest.fixture(scope="module")
def base_genome():
    rng = np.random.default_rng(1234)
    return rng.integers(0, 4, 200_000).astype(np.uint8)


def _run_both(tmp_path, fastas, monkeypatch, extra=(), skip=(), runs=1):
    """Run both CLIs ``runs`` times, each from its own working directory;
    return {name: bytes} per package, leaving out the files in skip."""
    outs = {}
    for name, fn, more in (("jax", jax_main, []), ("torch", torch_main, ["--device", "cpu"])):
        work = tmp_path / name
        work.mkdir()
        monkeypatch.chdir(work)
        for _ in range(runs):
            assert fn([*fastas, *ARGS, *extra, *more]) == 0
        outs[name] = {f: (work / f).read_bytes() for f in sorted(os.listdir(work))
                      if f not in skip}
    return outs["jax"], outs["torch"]


def _assert_same(j, t):
    assert sorted(j) == sorted(t)
    assert "test.synteny_blocks.tsv" in j
    for f in j:
        assert j[f] == t[f], f"{f} differs"


def _blocks(data: bytes):
    return [line.split("\t") for line in data.decode().splitlines()]


def _stage_names(tsv: bytes):
    return [line.split("\t")[0] for line in tsv.decode().splitlines()[1:]]


def test_translocation_identical(tmp_path, monkeypatch):
    rng = np.random.default_rng(77)
    c1 = rng.integers(0, 4, 120_000).astype(np.uint8)
    c2 = rng.integers(0, 4, 120_000).astype(np.uint8)
    b1 = np.concatenate([c1[:60_000], c2[60_000:]])  # genome B swaps the tails
    b2 = np.concatenate([c2[:60_000], c1[60_000:]])
    fa = write_fasta(tmp_path / "ga.fa", [("c1", c1), ("c2", c2)])
    fb = write_fasta(tmp_path / "gb.fa", [("c1", b1), ("c2", b2)])
    j, t = _run_both(tmp_path, [fa, fb], monkeypatch)
    _assert_same(j, t)
    rows = _blocks(t["test.synteny_blocks.tsv"])
    assert any(r[7] == "id_change" for r in rows)


def test_insertion_identical(tmp_path, base_genome, monkeypatch):
    rng = np.random.default_rng(5)
    ins = np.concatenate(
        [base_genome[:100_000], rng.integers(0, 4, 2000).astype(np.uint8), base_genome[100_000:]]
    )
    fa = write_fasta(tmp_path / "pa.fa", [("chr1", base_genome)])
    fb = write_fasta(tmp_path / "pb.fa", [("chr1", ins)])
    j, t = _run_both(tmp_path, [fa, fb], monkeypatch)
    _assert_same(j, t)
    assert any(r[7] in ("indel", "inconsistent_order") for r in _blocks(t["test.synteny_blocks.tsv"]))


def test_no_common_identical(tmp_path, base_genome, monkeypatch):
    mut = base_genome.copy()
    rng = np.random.default_rng(4)
    snp = rng.random(len(mut)) < 0.002
    mut[snp] = (mut[snp] + rng.integers(1, 4, int(snp.sum()))) % 4
    fa = write_fasta(tmp_path / "nc1.fa", [("chr1", base_genome)])
    fb = write_fasta(tmp_path / "nc2.fa", [("chr1", mut)])
    j, t = _run_both(tmp_path, [fa, fb], monkeypatch, extra=["--no-common"])
    _assert_same(j, t)
    assert "test.common.bf" not in t


def test_dry_run_and_artifacts_identical(tmp_path, base_genome, monkeypatch, capsys):
    fa = write_fasta(tmp_path / "x.fa", [("chr1", base_genome)])
    fb = write_fasta(tmp_path / "y.fa", [("chr1", base_genome)])
    # dry run: the same plan, and nothing written
    for repeat in (False, True):
        kw = dict(fastas=[fa, fb], k=24, w=100, prefix="test", out_dir=str(tmp_path),
                  repeat=repeat, dry_run=True)
        plan = NtSyntTPU(JaxConfig(**kw)).plan()
        assert NtSyntPipeline(PipelineConfig(device="cpu", **kw)).plan() == plan
    (tmp_path / "dry").mkdir()
    j, t = _run_both(tmp_path / "dry", [fa, fb], monkeypatch, extra=["-n"])
    assert j == t == {}
    steps = [line for line in capsys.readouterr().out.splitlines()
             if line.startswith(("read_fasta + faidx:", "build_", "sketch ", "synteny:"))]
    assert len(steps) == 2 * 6 and steps[:6] == steps[6:]  # the same plan from both CLIs
    # a real run with --benchmark: every artifact, the timings' stage names
    j, t = _run_both(tmp_path, [fa, fb], monkeypatch, extra=["--benchmark"],
                     skip=("test.time.tsv",))
    _assert_same(j, t)
    for f in ("x.fa.fai", "y.fa.fai", "x.fa.k24.w100.tsv", "test.common.bf",
              "test.pre-collinear-merge.synteny_blocks.tsv"):
        assert f in t, f
    assert _stage_names((tmp_path / "torch" / "test.time.tsv").read_bytes()) == _stage_names(
        (tmp_path / "jax" / "test.time.tsv").read_bytes()
    )


def test_sketch_artifact_reuse_identical(tmp_path, base_genome, monkeypatch):
    """A second run in the same directory reuses the sketch TSVs (no
    sketch stage) and writes the same blocks as the JAX CLI's second run."""
    fa = write_fasta(tmp_path / "r1.fa", [("chr1", base_genome)])
    fb = write_fasta(tmp_path / "r2.fa", [("chr1", base_genome)])
    j, t = _run_both(tmp_path, [fa, fb], monkeypatch, extra=["--benchmark"],
                     skip=("test.time.tsv",), runs=2)
    _assert_same(j, t)
    for name in ("jax", "torch"):
        stages = _stage_names((tmp_path / name / "test.time.tsv").read_bytes())
        assert "synteny" in stages and not any(s.startswith("sketch:") for s in stages), stages
