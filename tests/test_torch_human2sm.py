"""Soft-masked, N-gapped, repeat-laden assemblies through the port, as the
benchmark's human2sm_1g.div01 cell runs them: the harness
(synbench/run.py) driven on the CPU at a test size, correct and traced;
the counters a --benchmark CLI job writes for what such sequence adds
(the reads' N and lowercase bases, the dedupe's drops, the first graph's
branch nodes), each against a count made without the port; and the host
reader's two counts against NumPy's on the edges of its parallel fill."""

import collections
import json
import os

import numpy as np
import pytest

from synbench import gen, judge, run

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = (1 << 31) + 1
GENOMES = ["g00.fa", "g01.fa"]
PREFIX = "ntSynt.k24.w1000"


def _load(path):
    with open(os.path.join(ROOT, path)) as fin:
        return json.load(fin)


# human2sm_1g's repeats and soft-mask on three 200 kb contigs a genome;
# the gaps as tests/data/tiny_sm.json's, sized for 200 kb contigs
_CELL = _load("synbench/configs/human2sm_1g.json")
CONFIG = dict(_CELL, name="human2sm_test", genome_bp=600_000, contigs=3,
              sequence=dict(_CELL["sequence"],
                            gaps=_load("synbench/tests/data/tiny_sm.json")["sequence"]["gaps"]))
TRAFFIC = _load("synbench/traffic/div01.json")


def _bench(config_path):
    bench = _load("BENCHMARK.json")
    bench["configs"].append({"name": "human2sm_test", "file": config_path})
    bench["workloads"].append({"name": "human2sm_test.div01", "config": "human2sm_test",
                               "traffic": "div01", "chips": 1})
    return bench


def _counters(path):
    with open(path) as fin:
        rows = [line.rstrip("\n").split("\t") for line in fin][1:]
    return {name: int(value) for name, value in rows}


def test_traced_run_correct_with_dedupe_s(tmp_path, monkeypatch, capsys):
    """One traced run of the cell on the CPU (the harness's look for a
    card skipped, the jobs and the check on the CPU, no kernel library
    built: synbench/tests/test_synbench_correct.py's patches) is correct,
    and reads dedupe_s as the job's assembly.dedupe:* spans, the
    sketches' and each refinement round's."""
    from ntsynt_tpu_torch.ops import _kernels

    config = tmp_path / "human2sm_test.json"
    config.write_text(json.dumps(CONFIG))
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    argv, run_job = run.cli_argv, run.run_job
    jobs = []
    monkeypatch.setattr(run, "read_benchmark", lambda: _bench(str(config)))
    monkeypatch.setattr(run, "card", lambda chips: {
        "platform": "cpu", "kind": "cpu", "count": chips, "power_limit_w": None})
    monkeypatch.setattr(run, "cli_argv", lambda *a: argv(*a) + ["--device", "cpu"])
    monkeypatch.setattr(run, "CHECK_DEVICE", "cpu")
    monkeypatch.setattr(_kernels, "build", lambda: "")
    monkeypatch.setattr(run, "forbidden_loaded", lambda: [])
    monkeypatch.setattr(run, "run_job", lambda *a: jobs.append(run_job(*a)) or jobs[-1])
    line = run.run("human2sm_test.div01", SEED, 0.1, True)
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == line
    assert line["correct"], line["checks"]
    assert line["attempted"] == 1 and line["failed"] == 0
    limits = judge.limits()
    assert all(c["value"] <= limits[n] for n, c in line["checks"].items()), line["checks"]
    assert line["checks"]["sketch_diff"]["value"] == 0

    stages = jobs[0]["stages"]
    dedupe = {n: s for n, s in stages.items() if n.startswith("assembly.dedupe:")}
    w_rounds = [f"w{w}" for w in (100, 10)]
    assert sorted(dedupe) == sorted(
        [f"assembly.dedupe:{g}" for g in GENOMES]
        + [f"assembly.dedupe:{w}:{g}" for w in w_rounds for g in GENOMES])
    assert line["metrics"]["dedupe_s"]["value"] == pytest.approx(sum(dedupe.values()))
    # the sketches' dedupe runs inside assembly:<g>
    for g in GENOMES:
        assert stages[f"assembly.dedupe:{g}"] <= stages[f"assembly:{g}"]


@pytest.fixture(scope="module")
def cli_job(tmp_path_factory):
    """The cell's genomes for SEED and one --benchmark CLI job on them,
    in a directory of its own: (genomes, that directory, its counters)."""
    from ntsynt_tpu_torch.cli import main

    work = tmp_path_factory.mktemp("human2sm_cli")
    genomes = gen.make_genomes(CONFIG, TRAFFIC, SEED)
    fastas = gen.write_all(genomes, str(work))
    cwd = os.getcwd()
    os.chdir(work)
    try:
        assert main([*fastas, "-d", str(TRAFFIC["divergence_pct"]), "--device", "cpu",
                     "--benchmark"]) == 0
    finally:
        os.chdir(cwd)
    return genomes, work, _counters(work / f"{PREFIX}.counters.tsv")


def test_read_counters_equal_the_letters(cli_job):
    """read.n_bases:<g> and read.soft_bases:<g> are the N and the
    lowercase bases of the generator's letters."""
    genomes, _, counters = cli_job
    for g in genomes:
        n = int(np.count_nonzero(g.letters == ord("N")))
        soft = int(np.count_nonzero(np.isin(g.letters, np.frombuffer(b"acgt", np.uint8))))
        assert 0 < n < g.total and 0 < soft < g.total
        assert counters[f"read.n_bases:{g.name}"] == n
        assert counters[f"read.soft_bases:{g.name}"] == soft


def test_dedupe_counters_equal_a_counter_of_the_sketch(cli_job):
    """assembly.records, .dup_dropped and .dup_hashes of each genome are
    what a collections.Counter over the hashes of its sketch TSV gives."""
    genomes, work, counters = cli_job
    for g in genomes:
        seen = collections.Counter()
        with open(work / f"{g.name}.k24.w1000.tsv") as fin:
            for line in fin:
                _, _, recs = line.rstrip("\n").partition("\t")
                seen.update(r.split(":", 1)[0] for r in recs.split())
        repeated = [c for c in seen.values() if c > 1]
        assert repeated, "the planted repeats leave no minimizer twice in an assembly"
        assert counters[f"assembly.records:{g.name}"] == sum(seen.values())
        assert counters[f"assembly.dup_dropped:{g.name}"] == sum(repeated)
        assert counters[f"assembly.dup_hashes:{g.name}"] == len(repeated)
        assert counters[f"assembly.records:{g.name}"] == counters[
            f"write.records:sketch_tsv:{g.name}"]


def test_branch_nodes_equal_the_dot(cli_job):
    """synteny.branch_nodes is the number of nodes of degree > 2 in the
    .mx.dot, which is written from the first graph before
    simplify_bubbles; every refinement round counts its own graph."""
    _, work, counters = cli_job
    degree = collections.Counter()
    with open(work / f"{PREFIX}.mx.dot") as fin:
        for line in fin:
            if " -- " in line:
                u, _, rest = line.strip().partition(" -- ")
                degree.update([u, rest.split(" ", 1)[0]])
    branches = sum(1 for d in degree.values() if d > 2)
    assert branches > 0
    assert counters["synteny.branch_nodes"] == branches
    assert {"synteny.branch_nodes:w100", "synteny.branch_nodes:w10"} <= set(counters)


def _edge_fasta(path, rng, width: int):
    """Letters of ACGTacgtN in runs of 1-40 across 41 contigs of 1-700
    bases (most not a multiple of 8, so contigs share soft-mask bytes),
    N runs at contig starts and ends and across line breaks; written with
    lines of ``width`` bases (past 248, the reader's N count sums a line
    in several parts). Returns the letters, contigs end to end."""
    contigs = []
    for i in range(41):
        n = int(rng.integers(1, 700))
        runs = []
        while sum(len(r) for r in runs) < n:
            letter = rng.choice(list(b"ACGTacgtN"), p=[0.1] * 4 + [0.1] * 4 + [0.2])
            ln = int(rng.integers(1, 40))
            runs.append(np.full(ln, letter, np.uint8) if letter == ord("N") else
                        rng.choice(list(b"ACGT" if letter < 97 else b"acgt"), ln).astype(np.uint8))
        seq = np.concatenate(runs)[:n]
        if i % 3 == 0:
            seq[: min(n, 9)] = ord("N")
        if i % 4 == 1:
            seq[-min(n, 11):] = ord("N")
        contigs.append(seq)
    with open(path, "wb") as fout:
        for i, seq in enumerate(contigs):
            fout.write(f">c{i}\n".encode())
            for s in range(0, len(seq), width):
                fout.write(seq[s:s + width].tobytes() + b"\n")
    return np.concatenate(contigs)


@pytest.mark.parametrize("width,threads", [(7, 1), (7, 4), (61, 3), (80, 8), (1000, 2)])
def test_native_read_counts_equal_numpy(tmp_path, width, threads):
    """The host reader's counts, taken in its OpenMP fill, equal the NumPy
    reader's and the letters', with soft-mask bits kept and without."""
    from ntsynt_tpu_torch.io import fasta as fio

    letters = _edge_fasta(tmp_path / "e.fa", np.random.default_rng(width * 10 + threads), width)
    n = int(np.count_nonzero(letters == ord("N")))
    soft = int(np.count_nonzero(letters >= ord("a")))
    for keep_raw in (True, False):
        ref = fio.read_fasta(str(tmp_path / "e.fa"), keep_raw=keep_raw, native=False)
        got = fio.read_fasta(str(tmp_path / "e.fa"), keep_raw=keep_raw, native=True,
                             threads=threads)
        assert (ref.n_bases, ref.soft_bases) == (n, soft)
        assert (got.n_bases, got.soft_bases) == (n, soft)
        assert np.array_equal(got.codes, ref.codes)
        if keep_raw:
            assert np.array_equal(got.soft, ref.soft)
