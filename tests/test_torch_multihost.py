"""The port's multi-process entry (``python -m
ntsynt_tpu_torch.parallel.multihost``) on the CPU: gloo process groups of
two and three ranks, one process each, on the inversion pair of
tests/test_multihost.py.

Rank 0's blocks TSV must be byte-identical to the JAX package's
single-process run and to the port's; ranks other than 0 write nothing.
The --filter Indexlr run is held to the JAX package's single-process
run over a mesh of as many devices (--mesh): the repeat filter flags a
bit collision when the two k-mers lie in different segments, so its
words, and through them the minimizers, depend on where the segments
end (tests/test_parallel.py::test_distributed_repeat_bf_matches_single),
and a three-rank walk ends them where a three-device one does."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from ntsynt_tpu.cli import main as jax_main
from ntsynt_tpu.parallel import mesh as j_mesh
from ntsynt_tpu_torch.cli import main as torch_main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEC = np.array(list("ACGT"))
ARGS = ["-d", "1", "-k", "24", "-w", "100", "--w_rounds", "50", "10", "-b", "500",
        "--indel", "500", "--merge", "3000", "-p", "mh"]
BLOCKS = "mh.synteny_blocks.tsv"


def _write(path, codes):
    with open(path, "w") as f:
        s = "".join(DEC[codes])
        f.write(">chr1\n" + "\n".join(s[i : i + 70] for i in range(0, len(s), 70)) + "\n")
    return str(path)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_multihost")
    rng = np.random.default_rng(33)
    base = rng.integers(0, 4, 50_000).astype(np.uint8)
    mut = base.copy()
    mut[18_000:26_000] = mut[18_000:26_000][::-1] ^ 3  # engineered inversion
    snp = rng.random(len(mut)) < 0.001
    mut[snp] = (mut[snp] + rng.integers(1, 4, int(snp.sum()))) % 4
    return _write(tmp / "mhA.fa", base), _write(tmp / "mhB.fa", mut)


def _files(work):
    return {f: (work / f).read_bytes() for f in sorted(os.listdir(work))}


def _in_dir(work, fn, argv):
    """fn(argv) == 0 with work (made here) as the working directory."""
    work.mkdir(parents=True)
    cwd = os.getcwd()
    os.chdir(work)
    try:
        assert fn(argv) == 0
    finally:
        os.chdir(cwd)
    return _files(work)


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _multihost(root, world, argv, timeout=300):
    """world ranks of the multihost entry, rank r in root/rank<r> (made
    if missing, else run again in); a group whose port was taken
    meanwhile, before any rank wrote a file, is started once more.
    Returns each rank's files."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    dirs = [root / f"rank{r}" for r in range(world)]
    for work in dirs:
        work.mkdir(parents=True, exist_ok=True)
    for _ in range(2):
        port = _free_port()
        procs = []
        for r, work in enumerate(dirs):
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "ntsynt_tpu_torch.parallel.multihost", "--coordinator",
                 f"localhost:{port}", "--num-processes", str(world), "--process-id", str(r),
                 "--", *argv],
                cwd=work, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
        outs = []
        for p in procs:
            try:
                outs.append(p.communicate(timeout=timeout)[0].decode(errors="replace"))
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                raise
        if all(p.returncode == 0 for p in procs) or not any(
                "ddress already in use" in o for o in outs):
            break
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-4000:]}"
        assert f"[multihost] process {r}/{world}: 1 local / {world} global devices (cpu, gloo)" \
            in out, out[-2000:]
        assert f"[multihost] process {r} launches" in out  # the counts print (0 on the CPU)
    return [_files(d) for d in dirs]


@pytest.fixture(scope="module")
def singles(pair, tmp_path_factory):
    """The JAX package's and the port's single-process CLI runs."""
    root = tmp_path_factory.mktemp("torch_multihost_single")
    return {"jax": _in_dir(root / "jax", jax_main, [*pair, *ARGS]),
            "torch": _in_dir(root / "torch", torch_main, [*pair, *ARGS, "--device", "cpu"])}


def test_two_process_run_matches_single(pair, singles, tmp_path):
    """Two gloo ranks: rank 0 writes every artifact the port's
    single-process run writes, byte for byte, and the JAX package's
    blocks; rank 1 writes nothing."""
    rank0, rank1 = _multihost(tmp_path, 2, [*pair, *ARGS, "--device", "cpu"])
    assert singles["jax"][BLOCKS] == singles["torch"][BLOCKS]
    assert rank0 == singles["torch"]
    assert rank1 == {}
    rows = [line.split("\t") for line in rank0[BLOCKS].decode().splitlines()]
    assert any(r[5] == "-" for r in rows)  # the inversion


def test_two_process_rerun_reuses_rank0_artifacts(pair, singles, tmp_path):
    """A rerun in the same per-rank directories: rank 0 finds its sketch
    TSVs and filter stub fresh and reuses them while rank 1's directory
    is empty. Rank 0 decides for every rank, so both join the same
    collectives, and the rerun writes the first run's files."""
    argv = [*pair, *ARGS, "--device", "cpu"]
    first = _multihost(tmp_path, 2, argv)
    assert first[0] == singles["torch"] and first[1] == {}
    tsvs = [f for f in first[0] if f.endswith(".k24.w100.tsv")]
    assert len(tsvs) == 2
    mtimes = {f: os.path.getmtime(tmp_path / "rank0" / f) for f in tsvs}
    assert _multihost(tmp_path, 2, argv, timeout=120) == first
    assert {f: os.path.getmtime(tmp_path / "rank0" / f) for f in tsvs} == mtimes  # reused


def test_three_process_filter_indexlr_matches_jax_mesh(pair, tmp_path, monkeypatch):
    """Three gloo ranks with --filter Indexlr: rank 0's blocks equal the
    JAX package's single-process --filter Indexlr run over a three-device
    mesh; ranks 1 and 2 write nothing."""
    make_mesh = j_mesh.make_mesh
    monkeypatch.setattr(j_mesh, "make_mesh", lambda n_devices=None: make_mesh(n_devices or 3))
    extra = ["--filter", "Indexlr"]
    want = _in_dir(tmp_path / "jax", jax_main, [*pair, *ARGS, *extra, "--mesh"])
    ranks = _multihost(tmp_path, 3, [*pair, *ARGS, *extra, "--device", "cpu"])
    assert ranks[0][BLOCKS] == want[BLOCKS]
    assert "mh.repeat.bf" in ranks[0]
    assert ranks[1] == ranks[2] == {}


def test_one_process_mesh_cli_matches_single(pair, singles, tmp_path):
    """--mesh with no process group: a world of one rank, writing the
    single-process run's artifacts."""
    got = _in_dir(tmp_path / "mesh", torch_main, [*pair, *ARGS, "--device", "cpu", "--mesh"])
    assert got[BLOCKS] == singles["jax"][BLOCKS]
    assert got == singles["torch"]
