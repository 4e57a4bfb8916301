"""The port's CLI (--device cpu) against the JAX package's CLI on the
tests/test_e2e.py scenarios: every artifact (blocks TSVs, sketch TSVs,
.fai, graph, BF stub) must be byte-identical. Also: the port runs with
neither jax nor the JAX package loaded."""

import os
import subprocess
import sys

import numpy as np
import pytest

from ntsynt_tpu.cli import main as jax_main
from ntsynt_tpu_torch.cli import main as torch_main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
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


def _run_both(tmp_path, fastas, monkeypatch, extra=()):
    """Run both CLIs, each from its own working directory (they write
    their artifacts there); return {name: bytes} per package."""
    outs = {}
    for name, fn, more in (("jax", jax_main, []), ("torch", torch_main, ["--device", "cpu"])):
        work = tmp_path / name
        work.mkdir()
        monkeypatch.chdir(work)
        assert fn([*fastas, *ARGS, *extra, *more]) == 0
        outs[name] = {f: (work / f).read_bytes() for f in sorted(os.listdir(work))}
    return outs["jax"], outs["torch"]


def _assert_same(j, t):
    assert sorted(j) == sorted(t)
    assert "test.synteny_blocks.tsv" in j
    for f in j:
        assert j[f] == t[f], f"{f} differs"


def test_inversion_scenario_identical(tmp_path, base_genome, monkeypatch):
    inv = base_genome.copy()
    inv[80_000:130_000] = inv[80_000:130_000][::-1] ^ 3
    fa = write_fasta(tmp_path / "ref.fa", [("chr1", base_genome)])
    fb = write_fasta(tmp_path / "inv.fa", [("chr1", inv)])
    j, t = _run_both(tmp_path, [fa, fb], monkeypatch)
    _assert_same(j, t)
    rows = [line.split("\t") for line in t["test.synteny_blocks.tsv"].decode().splitlines()]
    assert len({r[0] for r in rows}) == 3
    assert any(r[5] == "-" for r in rows)


def test_three_genomes_identical(tmp_path, base_genome, monkeypatch):
    rng = np.random.default_rng(9)
    g2 = base_genome.copy()
    snp = rng.random(len(g2)) < 0.001
    g2[snp] = (g2[snp] + rng.integers(1, 4, snp.sum())) % 4
    g3 = base_genome.copy()
    g3[50_000:90_000] = g3[50_000:90_000][::-1] ^ 3
    fastas = [
        write_fasta(tmp_path / "g1.fa", [("chr1", base_genome)]),
        write_fasta(tmp_path / "g2.fa", [("chr1", g2)]),
        write_fasta(tmp_path / "g3.fa", [("chr1", g3)]),
    ]
    j, t = _run_both(tmp_path, fastas, monkeypatch)
    _assert_same(j, t)
    # determinism: a forced rerun of the port writes the same blocks
    monkeypatch.chdir(tmp_path / "torch")
    assert torch_main([*fastas, *ARGS, "-f", "--device", "cpu"]) == 0
    assert (tmp_path / "torch" / "test.synteny_blocks.tsv").read_bytes() == t[
        "test.synteny_blocks.tsv"
    ]


def test_cli_rejects_unported_flags_and_missing_cuda(tmp_path, base_genome, monkeypatch):
    fa = write_fasta(tmp_path / "a.fa", [("chr1", base_genome[:1000])])
    fb = write_fasta(tmp_path / "b.fa", [("chr1", base_genome[:1000])])
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit):
        torch_main([fa, fb, "-d", "1", "--mesh", "--device", "cpu"])
    with pytest.raises(SystemExit):
        torch_main([fa, fb, "-d", "1", "--filter", "Filter", "--device", "cpu"])
    import torch

    if not torch.cuda.is_available():  # the default device is cuda: no quiet fallback
        with pytest.raises(RuntimeError, match="CUDA"):
            torch_main([fa, fb, "-d", "1"])


def test_port_runs_without_jax(tmp_path, base_genome):
    """In a fresh interpreter, importing the port and running its CLI on
    the CPU loads neither jax nor the JAX package."""
    rng = np.random.default_rng(5)
    g = base_genome[:60_000]
    m = g.copy()
    snp = rng.random(len(m)) < 0.002
    m[snp] = (m[snp] + 1) % 4
    fa = write_fasta(tmp_path / "x.fa", [("chr1", g)])
    fb = write_fasta(tmp_path / "y.fa", [("chr1", m)])
    code = (
        "import sys\n"
        "import ntsynt_tpu_torch\n"
        "from ntsynt_tpu_torch.cli import main\n"
        f"rc = main([{fa!r}, {fb!r}, '-d', '1', '-w', '100', '--w_rounds', '50', '10',"
        " '-b', '500', '--indel', '500', '--merge', '3000', '-p', 'nj', '--device', 'cpu'])\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'ntsynt_tpu' or m.startswith('ntsynt_tpu.'))\n"
        "assert rc == 0 and not bad, bad\n"
        "print('NO_JAX_OK')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NO_JAX_OK" in proc.stdout
    assert (tmp_path / "nj.synteny_blocks.tsv").exists()
