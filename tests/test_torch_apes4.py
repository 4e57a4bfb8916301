"""Four assemblies through the port, as the benchmark's apes4_500m.div13
cell runs them (upstream's four-great-ape deployment): the benchmark
harness (synbench/run.py) driven on the CPU at a test size, sound, with a
block's row planted on the wrong strand, and traced; and the port
against the JAX package on a four-genome star."""

import json
import os
import textwrap

import numpy as np
import pytest

from synbench import judge, run
from tests.test_torch_published_shapes import mutate, write_fasta

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = (1 << 31) + 1818
GENOMES = [f"g{i:02d}.fa" for i in range(4)]

# apes4_500m's layout (four genomes, four shared contigs) at 2 Mbp a genome
CONFIG = {"name": "apes4_test", "source": "apes4_500m at a test size", "genomes": 4,
          "genome_bp": 2_000_000, "contigs": 4}

SITE = {
    # block 0's row of g03 written on the other strand
    "wrong_strand": """
        from ntsynt_tpu_torch.core import blocks
        inner = blocks.BlockSet.block_rows
        def block_rows(self, block, num, verbose=False):
            rows = inner(self, block, num, verbose).split("\\n")
            if num == 0:
                for i, row in enumerate(rows):
                    f = row.split("\\t")
                    if len(f) > 5 and f[1] == "g03.fa":
                        f[5] = "-" if f[5] == "+" else "+"
                        rows[i] = "\\t".join(f)
            return "\\n".join(rows)
        blocks.BlockSet.block_rows = block_rows
    """,
    # every lookup through the batched branch, whose joins are spans: at
    # this size no lookup reaches synteny.BATCH_LOOKUP queries
    "batched_lookups": """
        from ntsynt_tpu_torch.core import synteny
        synteny.BATCH_LOOKUP = 1
    """,
}


def _bench(config_path):
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fin:
        bench = json.load(fin)
    bench["configs"].append({"name": "apes4_test", "file": config_path})
    bench["workloads"].append({"name": "apes4_test.div13", "config": "apes4_test",
                               "traffic": "div13", "chips": 1})
    return bench


def _run(tmp_path, monkeypatch, capsys, site=None, trace=False):
    """One run of the four-genome cell on the CPU (the harness's look for a
    card skipped, the jobs and the check on the CPU, no kernel library
    built: synbench/tests/test_synbench_correct.py's patches; this test
    process imports JAX through tests/conftest.py, so the harness looks
    for forbidden modules only in the jobs, which report their own); returns
    (its result line, the jobs as run_job returned them, the blocks the
    check read)."""
    from ntsynt_tpu_torch.ops import _kernels

    config = tmp_path / "apes4_test.json"
    config.write_text(json.dumps(CONFIG))
    if site:
        d = tmp_path / "site"
        d.mkdir()
        (d / "sitecustomize.py").write_text(textwrap.dedent(SITE[site]))
        monkeypatch.setenv("PYTHONPATH", str(d))
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    argv, run_job, read_blocks = run.cli_argv, run.run_job, judge.read_blocks
    jobs, blocks = [], []
    monkeypatch.setattr(run, "read_benchmark", lambda: _bench(str(config)))
    monkeypatch.setattr(run, "card", lambda chips: {
        "platform": "cpu", "kind": "cpu", "count": chips, "power_limit_w": None})
    monkeypatch.setattr(run, "cli_argv", lambda *a: argv(*a) + ["--device", "cpu"])
    monkeypatch.setattr(run, "CHECK_DEVICE", "cpu")
    monkeypatch.setattr(_kernels, "build", lambda: "")
    monkeypatch.setattr(run, "forbidden_loaded", lambda: [])
    monkeypatch.setattr(run, "run_job", lambda *a: jobs.append(run_job(*a)) or jobs[-1])
    monkeypatch.setattr(judge, "read_blocks", lambda p: blocks.append(read_blocks(p))
                        or blocks[-1])
    line = run.run("apes4_test.div13", SEED, 0.1, trace)
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == line
    return line, jobs, blocks


def test_four_genomes_correct(tmp_path, monkeypatch, capsys):
    line, jobs, blocks = _run(tmp_path, monkeypatch, capsys, trace=True)
    assert line["correct"], line["checks"]
    limits = judge.limits()
    assert all(c["value"] <= limits[n] for n, c in line["checks"].items()), line["checks"]
    assert line["attempted"] == 1 and line["failed"] == 0
    # every block has a row in each of the four assemblies
    assert blocks[0] and all(sorted(rows) == GENOMES for rows in blocks[0].values())
    # the cascade's four levels, one span each, read by bf_level_s as their mean
    stages = jobs[0]["stages"]
    levels = {n: s for n, s in stages.items() if n.startswith("bf.level:")}
    assert sorted(levels) == [f"bf.level:{g}" for g in GENOMES]
    assert line["metrics"]["bf_level_s"]["value"] == pytest.approx(sum(levels.values()) / 4)
    assert sum(levels.values()) <= stages["make_common_bf"]


def test_wrong_strand_caught(tmp_path, monkeypatch, capsys):
    line, _, blocks = _run(tmp_path, monkeypatch, capsys, site="wrong_strand")
    assert not line["correct"]
    # judge.block_errors charges a row on the wrong strand the block's length
    _, s, e, _ = blocks[0]["0"]["g00.fa"]
    assert line["checks"]["block_err_bp"]["value"] == e - s
    assert line["checks"]["block_err_bp"]["value"] > line["checks"]["block_err_bp"]["limit"]


def test_traced_run_has_level_and_join_spans(tmp_path, monkeypatch, capsys):
    line, jobs, _ = _run(tmp_path, monkeypatch, capsys, site="batched_lookups", trace=True)
    assert line["correct"], line["checks"]
    stages = jobs[0]["stages"]
    assert sorted(n for n in stages if n.startswith("bf.level:")) == [
        f"bf.level:{g}" for g in GENOMES]
    joins = {n: s for n, s in stages.items() if n.startswith("synteny.join:")}
    assert sorted(joins) == [f"synteny.join:{g}" for g in GENOMES]
    assert line["metrics"]["synteny_join_s"]["value"] == pytest.approx(sum(joins.values()))
    assert line["metrics"]["bf_level_s"]["value"] > 0
    # the joins run inside synteny.lookup
    assert sum(joins.values()) <= stages["synteny.lookup"]


def test_four_genome_star_same_as_jax(tmp_path, monkeypatch, capsys):
    """A 200 kb star: genomes 1-3 each at 1.3% SNPs of their own from
    genome 0, genome 1 inverted at 80-130 kb, under -d 1.3. Every
    artifact (blocks TSV, sketch TSVs, ...) and the cascade's printed
    occupancies byte for byte against the JAX CLI."""
    from ntsynt_tpu.cli import main as jax_main
    from ntsynt_tpu_torch.cli import main as torch_main

    rng = np.random.default_rng(1300)
    base = rng.integers(0, 4, 200_000).astype(np.uint8)
    fastas = []
    for gi in range(4):
        g = base if gi == 0 else mutate(rng, base, 0.013)
        if gi == 1:
            g[80_000:130_000] = g[80_000:130_000][::-1] ^ 3
        fastas.append(write_fasta(tmp_path / f"s{gi}.fa", [("chr1", g)]))
    outs, occ = {}, {}
    for name, fn, more in (("jax", jax_main, []), ("torch", torch_main, ["--device", "cpu"])):
        work = tmp_path / name
        work.mkdir()
        monkeypatch.chdir(work)
        capsys.readouterr()
        assert fn([*fastas, "-d", "1.3", "-p", "test", *more]) == 0
        occ[name] = [ln.split(" : ", 1)[1] for ln in capsys.readouterr().out.splitlines()
                     if "BF occupancy/FPR" in ln]
        outs[name] = {f: (work / f).read_bytes() for f in sorted(os.listdir(work))}
    assert len(occ["torch"]) == 4 and occ["torch"] == occ["jax"]
    assert sorted(outs["torch"]) == sorted(outs["jax"])
    assert {f"s{gi}.fa.k24.w1000.tsv" for gi in range(4)} <= set(outs["torch"])
    for f in outs["jax"]:
        assert outs["jax"][f] == outs["torch"][f], f"{f} differs"
    rows = [ln.split("\t") for ln in outs["torch"]["test.synteny_blocks.tsv"].decode().splitlines()]
    ids = {r[0] for r in rows}
    assert ids and len(rows) == 4 * len(ids)
    # s1 alone runs against the others in some block (its inversion)
    assert any(len({r[5] for r in rows if r[0] == i and r[1] != "s1.fa"}) == 1
               and {r[5] for r in rows if r[0] == i and r[1] == "s1.fa"}
               != {r[5] for r in rows if r[0] == i and r[1] == "s0.fa"} for i in ids)
