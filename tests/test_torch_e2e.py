"""The port's CLI (--device cpu) against the JAX package's CLI on the
tests/test_e2e.py scenarios: every artifact (blocks TSVs, sketch TSVs,
.fai, graph, BF stubs) must be byte-identical, with and without the
repeat filter (--filter Indexlr|Filter); byte-complete .bf files from
the pipeline and the synteny-only entry point (run_core) likewise, and
on soft-masked genomes. Also:
the port runs with neither jax nor the JAX package loaded."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from ntsynt_tpu import run_core as jax_run_core
from ntsynt_tpu.cli import main as jax_main
from ntsynt_tpu.core.pipeline import NtSyntTPU, PipelineConfig as JaxConfig
from ntsynt_tpu_torch import run_core as torch_run_core
from ntsynt_tpu_torch.cli import main as torch_main
from ntsynt_tpu_torch.core.pipeline import NtSyntPipeline, PipelineConfig

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


def _files(work, skip=()):
    return {f: (work / f).read_bytes() for f in sorted(os.listdir(work)) if f not in skip}


def _run_both(tmp_path, fastas, monkeypatch, extra=(), args=ARGS, skip=(), runs=1):
    """Run both CLIs, each from its own working directory (they write
    their artifacts there), ``runs`` times; return {name: bytes} per
    package, leaving out the files named in skip."""
    outs = {}
    for name, fn, more in (("jax", jax_main, []), ("torch", torch_main, ["--device", "cpu"])):
        work = tmp_path / name
        work.mkdir(exist_ok=True)
        monkeypatch.chdir(work)
        for _ in range(runs):
            assert fn([*fastas, *args, *extra, *more]) == 0
        outs[name] = _files(work, skip)
    return outs["jax"], outs["torch"]


def _assert_same(j, t):
    assert sorted(j) == sorted(t)
    assert "test.synteny_blocks.tsv" in j
    for f in j:
        assert j[f] == t[f], f"{f} differs"


def _blocks(data: bytes):
    return [line.split("\t") for line in data.decode().splitlines()]


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


def test_soft_masked_scenario_identical(tmp_path, base_genome, monkeypatch):
    """Soft-masked genomes, lowercase runs over about a third of each:
    every artifact byte-identical to the JAX package's, the sketch TSVs'
    k-mers keeping their case (some lowercase, some mixed)."""
    rng = np.random.default_rng(21)
    other = base_genome.copy()
    snp = rng.random(len(other)) < 0.002
    other[snp] = (other[snp] + rng.integers(1, 4, snp.sum())) % 4
    other[60_000:110_000] = other[60_000:110_000][::-1] ^ 3
    fastas = []
    for name, g in (("sa.fa", base_genome), ("sb.fa", other)):
        raw = np.frombuffer(b"ACGT", np.uint8)[g]
        lower = np.zeros(len(raw), bool)
        for start in rng.integers(0, len(raw), 150):
            lower[start : start + int(rng.integers(20, 900))] = True
        assert 0.25 < lower.mean() < 0.45
        raw = np.where(lower, raw + 32, raw).astype(np.uint8)
        body = b"\n".join(raw[i : i + 70].tobytes() for i in range(0, len(raw), 70))
        (tmp_path / name).write_bytes(b">chr1\n" + body + b"\n")
        fastas.append(str(tmp_path / name))
    j, t = _run_both(tmp_path, fastas, monkeypatch)
    _assert_same(j, t)
    assert len(_blocks(t["test.synteny_blocks.tsv"])) >= 3
    seqs = [rec.split(":")[2] for f in ("sa.fa.k24.w100.tsv", "sb.fa.k24.w100.tsv")
            for line in t[f].decode().splitlines() for rec in line.split("\t")[1].split()]
    assert any(s.islower() for s in seqs) and any(s.isupper() for s in seqs)
    assert any(not s.islower() and not s.isupper() for s in seqs)


def test_cli_rejects_unported_flags_and_missing_cuda(tmp_path, base_genome, monkeypatch, capsys):
    """Every flag of the JAX CLI is ported (--mesh since the mesh slice,
    tests/test_torch_multihost.py); a flag neither CLI has is rejected,
    and the default device raises without CUDA."""
    fa = write_fasta(tmp_path / "a.fa", [("chr1", base_genome[:1000])])
    fb = write_fasta(tmp_path / "b.fa", [("chr1", base_genome[:1000])])
    monkeypatch.chdir(tmp_path)
    assert torch_main([fa, fb, "-d", "1", "--mesh", "--device", "cpu", "-n"]) == 0
    assert "synteny:" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        torch_main([fa, fb, "-d", "1", "--no-such-flag", "--device", "cpu"])
    import torch

    if not torch.cuda.is_available():  # the default device is cuda: no quiet fallback
        with pytest.raises(RuntimeError, match="CUDA"):
            torch_main([fa, fb, "-d", "1"])


def test_port_runs_without_jax(tmp_path, base_genome):
    """In a fresh interpreter, importing the port and running its CLI on
    the CPU (with -t, with and without --filter), its make-bf CLIs,
    run_core, the sidecar CLIs and the one-process multihost entry (a
    gloo group of one rank, whose blocks equal the CLI's) loads neither
    jax nor the JAX package,
    and never opens the JAX package's csrc/*.so: the FASTA reads and the
    chain walk go through the port's own host library."""
    rng = np.random.default_rng(5)
    g = base_genome[:60_000]
    m = g.copy()
    snp = rng.random(len(m)) < 0.002
    m[snp] = (m[snp] + 1) % 4
    fa = write_fasta(tmp_path / "x.fa", [("chr1", g)])
    fb = write_fasta(tmp_path / "y.fa", [("chr1", m)])
    csrc = os.path.join(REPO, "csrc")
    sock = socket.socket()
    sock.bind(("localhost", 0))
    port = sock.getsockname()[1]
    sock.close()
    code = (
        "import os, sys\n"
        f"CSRC = {csrc!r}\n"
        "opened = []\n"
        "def hook(event, args):\n"
        "    if event in ('open', 'ctypes.dlopen') and isinstance(args[0], (str, bytes)):\n"
        "        p = os.path.abspath(os.fsdecode(args[0]))\n"
        "        if p.startswith(CSRC + os.sep) and p.endswith('.so'):\n"
        "            opened.append(p)\n"
        "sys.addaudithook(hook)\n"
        "import ntsynt_tpu_torch\n"
        "from ntsynt_tpu_torch.cli import main\n"
        f"rc = main([{fa!r}, {fb!r}, '-d', '1', '-w', '100', '--w_rounds', '50', '10',"
        " '-b', '500', '--indel', '500', '--merge', '3000', '-p', 'nj', '-t', '3',"
        " '--device', 'cpu'])\n"
        f"rc |= main([{fa!r}, {fb!r}, '-d', '1', '-w', '100', '--w_rounds', '50', '10',"
        " '--filter', 'Filter', '-p', 'nf', '-t', '1', '--device', 'cpu'])\n"
        "from ntsynt_tpu_torch import make_bf, run_core\n"
        f"rc |= make_bf.common_main(['--genome', {fa!r}, {fb!r}, '-k', '24', '-p', 'c',"
        " '-t', '2', '--device', 'cpu'])\n"
        f"rc |= make_bf.repeat_main(['--genome', {fa!r}, '-k', '24', '-p', 'r', '--format',"
        " 'native', '-t', '2', '--device', 'cpu'])\n"
        f"rc |= run_core.main(['x.fa.k24.w100.tsv', 'y.fa.k24.w100.tsv', '--fastas', {fa!r},"
        f" {fb!r}, '-k', '24', '-w', '100', '--w-rounds', '50', '10', '--common', 'c.bf',"
        " '--repeat', 'r.bf', '--filter', 'Indexlr', '-p', 'rc', '--btllib_t', '2',"
        " '--device', 'cpu'])\n"
        "from ntsynt_tpu_torch.analysis import stats\n"
        "from ntsynt_tpu_torch.viz import cli as viz\n"
        "stats.main(['--tsv', 'nj.synteny_blocks.tsv', '--fai', 'x.fa.fai', 'y.fa.fai'])\n"
        "rc |= viz.sort_blocks_main(['--synteny_blocks', 'nj.synteny_blocks.tsv',"
        " '--sort_order', 'y.fa', 'x.fa'])\n"
        "rc |= viz.gggenomes_main(['--fai', 'x.fa.fai', 'y.fa.fai', '--blocks',"
        " 'nj.synteny_blocks.tsv', '-p', 'gv', '-l', '1000'])\n"
        "rc |= viz.painting_main(['nj.synteny_blocks.tsv', '--target', 'x.fa', '-o', 'pt.tsv'])\n"
        "from ntsynt_tpu_torch.parallel import make_mesh, multihost\n"
        f"rc |= multihost.main(['--coordinator', 'localhost:{port}', '--num-processes', '1',"
        f" '--process-id', '0', '--', {fa!r}, {fb!r}, '-d', '1', '-w', '100', '--w_rounds',"
        " '50', '10', '-b', '500', '--indel', '500', '--merge', '3000', '-p', 'mh', '-t', '3',"
        " '--device', 'cpu'])\n"
        "assert make_mesh(device='cpu').size == 1  # the group is gone\n"
        "assert open('mh.synteny_blocks.tsv').read() == open('nj.synteny_blocks.tsv').read()\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'ntsynt_tpu' or m.startswith('ntsynt_tpu.'))\n"
        "maps = open('/proc/self/maps').read()\n"
        "assert rc == 0 and not bad, bad\n"
        "assert not opened and CSRC + os.sep not in maps, opened\n"
        "assert 'libntsynt_host.so' in maps\n"
        "print('NO_JAX_OK')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NO_JAX_OK" in proc.stdout
    assert "Number_blocks\t" in proc.stdout
    assert "[multihost] process 0/1: 1 local / 1 global devices (cpu, gloo)" in proc.stdout
    for f in ("nj.synteny_blocks.tsv", "nf.synteny_blocks.tsv", "nf.repeat.bf", "c.bf", "r.bf",
              "rc.synteny_blocks.tsv", "gv.links.tsv", "gv.sequence_lengths.tsv", "pt.tsv"):
        assert (tmp_path / f).exists(), f


# ---------------------------------------------------------------------------
# the repeat-filter paths (tests/test_e2e.py::test_cli_filter_repeat_path)
# ---------------------------------------------------------------------------

FILTER_ARGS = ["-d", "0.5", "-k", "24", "-w", "100", "--w_rounds", "50", "10",
               "--indel", "500", "--merge", "3000", "-p", "test", "-f"]


@pytest.fixture(scope="module")
def repeat_scenario(tmp_path_factory, base_genome):
    """A tandem-duplicated region seeds the repeat filter; genome b
    carries an inversion."""
    tmp = tmp_path_factory.mktemp("torch_filter")
    g = base_genome.copy()
    g[150_000:160_000] = g[140_000:150_000]  # tandem repeat (multiplicity 2)
    g2 = g.copy()
    g2[40_000:80_000] = g2[40_000:80_000][::-1] ^ 3
    return (write_fasta(tmp / "ra.fa", [("chr1", g)]),
            write_fasta(tmp / "rb.fa", [("chr1", g2)]))


@pytest.mark.parametrize("mode", ["Indexlr", "Filter"])
def test_cli_filter_identical(tmp_path, repeat_scenario, monkeypatch, mode):
    """--filter Indexlr|Filter: the blocks TSV, the pre-merge TSV, every
    sketch TSV and the .repeat.bf (a resume stub, as the JAX CLI writes
    it) are byte-identical to the JAX CLI's."""
    j, t = _run_both(tmp_path, list(repeat_scenario), monkeypatch,
                     extra=["--filter", mode], args=FILTER_ARGS)
    _assert_same(j, t)
    for f in ("test.repeat.bf", "test.pre-collinear-merge.synteny_blocks.tsv",
              "ra.fa.k24.w100.tsv", "rb.fa.k24.w100.tsv"):
        assert f in t, f
    assert any(r[5] == "-" for r in _blocks(t["test.synteny_blocks.tsv"]))


@pytest.fixture(scope="module")
def full_bf_runs(tmp_path_factory, repeat_scenario):
    """Both pipelines with the repeat filter (Indexlr) and byte-complete
    .bf artifacts (the JAX pipeline's repeat segment is its sketch chunk,
    2^20, the port's bf_build.PIPELINE_CHUNK)."""
    root = tmp_path_factory.mktemp("torch_full_bf")
    kw = dict(fastas=list(repeat_scenario), k=24, w=100, w_rounds=(50, 10), block_size=500,
              indel=500, merge="3000", prefix="full", repeat=True, repeat_filter="Indexlr",
              bf_artifact="full")
    runs = {}
    for name, cls, cfg in (("jax", NtSyntTPU, JaxConfig(out_dir=str(root / "jax"), **kw)),
                           ("torch", NtSyntPipeline,
                            PipelineConfig(out_dir=str(root / "torch"), device="cpu", **kw))):
        os.makedirs(cfg.out_dir)
        cls(cfg).run()
        runs[name] = (root / name, cls, cfg)
    return runs


def test_pipeline_full_bf_artifacts_identical(full_bf_runs):
    """Byte-complete .common.bf and .repeat.bf (native containers) and
    every other artifact match; a rerun reuses both filters through
    load_bf and writes the same blocks."""
    (jdir, _, _), (tdir, tcls, tcfg) = full_bf_runs["jax"], full_bf_runs["torch"]
    j, t = _files(jdir), _files(tdir)
    assert sorted(j) == sorted(t)
    for f in ("full.common.bf", "full.repeat.bf", "full.synteny_blocks.tsv"):
        assert f in t, f
    for f in j:
        assert j[f] == t[f], f"{f} differs"
    assert b'"magic": "ntsynt_tpu_bf1"' in t["full.repeat.bf"][:100]
    mtimes = {f: os.path.getmtime(tdir / f) for f in ("full.common.bf", "full.repeat.bf")}
    runner = tcls(tcfg)
    runner.run()
    assert {f: os.path.getmtime(tdir / f) for f in mtimes} == mtimes
    assert _files(tdir) == t
    assert "make_repeat_bf" in runner.timer.stages


@pytest.mark.parametrize("mode", ["Filter", "Indexlr"])
def test_run_core_matches_jax(full_bf_runs, repeat_scenario, tmp_path, mode):
    """The synteny-only entry point on the pipeline's sketch TSVs, with
    the byte-complete common and repeat filters, in both --filter modes."""
    jdir = full_bf_runs["jax"][0]
    outs = {}
    for name, fn, more in (("jax", jax_run_core.main, []),
                           ("torch", torch_run_core.main, ["--device", "cpu"])):
        work = tmp_path / name
        work.mkdir()
        argv = [str(jdir / "ra.fa.k24.w100.tsv"), str(jdir / "rb.fa.k24.w100.tsv"),
                "--fastas", *repeat_scenario, "-k", "24", "-w", "100", "--w-rounds", "50", "10",
                "--bp", "500", "--collinear-merge", "3000", "--common", str(jdir / "full.common.bf"),
                "--repeat", str(jdir / "full.repeat.bf"), "--filter", mode, "-p", str(work / "rc")]
        assert fn(argv + more) == 0
        outs[name] = _files(work)
    assert sorted(outs["jax"]) == sorted(outs["torch"])
    assert "rc.synteny_blocks.tsv" in outs["torch"]
    for f in outs["jax"]:
        assert outs["jax"][f] == outs["torch"][f], f"{f} differs"
