"""The check that decides ``correct``, driven through a whole run on the
CPU at a test size (the harness's look for a card skipped, the jobs run
with --device cpu): a sound run is correct, and a run whose timed path is
broken underneath is not, once for each fault the cells can have. Also
the control: the reference with half the filter's bits fails the sketch
comparison. The soft-masked, gapped pair (tests/data/tiny_sm.json) is
held the same way."""

import json
import os
import textwrap

import numpy as np
import pytest

from synbench import control, gen, judge, run

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SEED = (1 << 31) + 4242

FAULTS = {
    # a cascade step that returns its state unchanged: every level after
    # the first leaves the filter as the first level made it
    "state_unchanged": """
        from ntsynt_tpu_torch.ops import bf_build
        inner = bf_build.build_common_bf_from_device
        def build(entries, *args, **kw):
            return inner(entries[:1], *args, **kw)
        bf_build.build_common_bf_from_device = build
    """,
    # an answer altered where it is produced: one sketch record's position
    "record_altered": """
        from ntsynt_tpu_torch.io import sketch_tsv
        inner = sketch_tsv.write_sketch_tsv
        def write_sketch_tsv(path, recs):
            recs = list(recs)
            name, h, p, s = recs[0]
            p = p.copy(); p[0] += 1
            return inner(path, [(name, h, p, s)] + recs[1:])
        sketch_tsv.write_sketch_tsv = write_sketch_tsv
    """,
    # an answer altered where it is produced: the first block's second row
    # ends k bases short
    "block_end_altered": """
        from ntsynt_tpu_torch.core import blocks
        inner = blocks.BlockSet.block_rows
        def block_rows(self, block, num, verbose=False):
            rows = inner(self, block, num, verbose).split("\\n")
            if num == 0:
                f = rows[1].split("\\t")
                f[4] = str(int(f[4]) - self.k)
                rows[1] = "\\t".join(f)
            return "\\n".join(rows)
        blocks.BlockSet.block_rows = block_rows
    """,
    # half of the batch left out: every other block not written
    "half_left_out": """
        from ntsynt_tpu_torch.core import blocks
        inner = blocks.BlockSet.write_blocks_tsv
        def write_blocks_tsv(self, path, bl, min_length, verbose=False):
            return inner(self, path, list(bl)[::2], min_length, verbose)
        blocks.BlockSet.write_blocks_tsv = write_blocks_tsv
    """,
}


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fin:
        bench = json.load(fin)
    for name in ("tiny", "tiny_sm"):
        bench["configs"].append({"name": name, "file": f"synbench/tests/data/{name}.json"})
        bench["workloads"].append({"name": f"{name}.div01", "config": name, "traffic": "div01",
                                   "chips": 1})
    return bench


def _on_cpu(monkeypatch):
    """The harness's look for a card skipped, the jobs run with --device
    cpu, the check's reference on the CPU, and no kernel library built
    (the CPU path needs none)."""
    from ntsynt_tpu_torch.ops import _kernels

    argv = run.cli_argv
    monkeypatch.setattr(run, "read_benchmark", _bench)
    monkeypatch.setattr(run, "card", lambda chips: {
        "platform": "cpu", "kind": "cpu", "count": chips, "power_limit_w": None})
    monkeypatch.setattr(run, "cli_argv", lambda *a: argv(*a) + ["--device", "cpu"])
    monkeypatch.setattr(run, "CHECK_DEVICE", "cpu")
    monkeypatch.setattr(_kernels, "build", lambda: "")


def _run(tmp_path, monkeypatch, capsys, fault=None, trace=False, workload="tiny.div01"):
    if fault:
        d = tmp_path / "fault"
        d.mkdir()
        (d / "sitecustomize.py").write_text(textwrap.dedent(FAULTS[fault]))
        monkeypatch.setenv("PYTHONPATH", str(d))
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    _on_cpu(monkeypatch)
    line = run.run(workload, SEED, 0.1, trace)
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == line
    assert list(line)[-1] == "checks"
    return line


def test_sound_run_is_correct(tmp_path, monkeypatch, capsys):
    line = _run(tmp_path, monkeypatch, capsys, trace=True)
    assert line["correct"], line["checks"]
    assert line["attempted"] == 1 and line["failed"] == 0
    for name in ("startup_s", "read_s", "common_bf_s", "sketch_s", "synteny_s"):
        assert line["metrics"][name]["value"] > 0
    # the run's genomes and jobs are gone (torch may leave its own caches)
    assert not [p for p in os.listdir(tmp_path) if p.startswith("synbench-")]


@pytest.mark.parametrize("fault,number", [
    ("state_unchanged", "cascade_diff"),
    ("record_altered", "sketch_diff"),
    ("block_end_altered", "block_err_bp"),
    ("half_left_out", "uncovered_pct"),
])
def test_a_broken_run_is_not_correct(tmp_path, monkeypatch, capsys, fault, number):
    line = _run(tmp_path, monkeypatch, capsys, fault=fault)
    assert not line["correct"]
    c = line["checks"][number]
    assert c["value"] > c["limit"], line["checks"]


def test_soft_masked_gapped_run_is_correct(tmp_path, monkeypatch, capsys):
    """Repeats, lowercase and N through the port and the plain reference
    on the CPU: the cascade and every sketch record agree, and the blocks
    leave next to none of the non-N bases uncovered."""
    line = _run(tmp_path, monkeypatch, capsys, workload="tiny_sm.div01")
    assert line["correct"], line["checks"]
    c = line["checks"]
    assert c["cascade_diff"]["value"] == 0 and c["sketch_diff"]["value"] == 0
    assert 0 <= c["uncovered_pct"]["value"] <= c["uncovered_pct"]["limit"]


@pytest.mark.parametrize("fault,number", [
    ("state_unchanged", "cascade_diff"),
    ("record_altered", "sketch_diff"),
    ("block_end_altered", "block_err_bp"),
    ("half_left_out", "uncovered_pct"),
])
def test_a_broken_soft_masked_run_is_not_correct(tmp_path, monkeypatch, capsys, fault, number):
    line = _run(tmp_path, monkeypatch, capsys, fault=fault, workload="tiny_sm.div01")
    assert not line["correct"]
    c = line["checks"][number]
    assert c["value"] > c["limit"], line["checks"]


def _two(gaps):
    """Genome A and a copy, 1000 bases in one contig, with these gaps."""
    return [gen.Genome(gen.genome_name(i), np.zeros(1000, np.uint8), ["chr1"],
                       np.array([1000]), None, None, None, gaps) for i in range(2)]


@pytest.mark.parametrize("spans,gaps,want", [
    # no N: the share of all bases, as before N was counted apart
    ([(0, 900)], None, 10.0),
    ([(0, 900)], np.zeros((0, 2), np.int64), 10.0),
    ([(0, 100), (300, 750)], None, 45.0),
    # a gap of 100 N inside [100, 200) and one at the end: 850 non-N bases
    ([(0, 100), (200, 900)], np.array([[100, 200], [950, 1000]]), 100 * 50 / 850),
    # a block across the gap is not held to its N
    ([(0, 950)], np.array([[100, 200], [950, 1000]]), 0.0),
    # covered: [200, 500) of it non-N
    ([(150, 500)], np.array([[100, 200], [950, 1000]]), 100 * 550 / 850),
])
def test_uncovered_pct_counts_non_n_bases(spans, gaps, want):
    gs = _two(gaps)
    blocks = {str(i): {g.name: ("chr1", s, e, "+") for g in gs} for i, (s, e) in enumerate(spans)}
    err, unc = judge.block_errors(blocks, gs)
    assert err == 0
    assert unc == pytest.approx(want, abs=1e-9)


def test_control_fails_the_sketch(tmp_path):
    config = json.load(open(os.path.join(ROOT, "synbench", "tests", "data", "tiny.json")))
    traffic = json.load(open(os.path.join(ROOT, "synbench", "traffic", "div01.json")))
    genomes = gen.make_genomes(config, traffic, SEED)
    fastas = gen.write_all(genomes, str(tmp_path / "fasta"))
    job = run.run_job(str(tmp_path / "job"), str(tmp_path / "keep"),
                      run.cli_argv(fastas, traffic, False) + ["--device", "cpu"], False,
                      genomes)
    assert job["ok"]
    r = control.readings(job["dir"], genomes, "cpu")
    limits = judge.limits()
    assert all(r["sound"][n] <= limits[n] for n in limits), r["sound"]
    assert r["control"]["sketch_diff"] > limits["sketch_diff"]
    assert r["control"]["cascade_diff"] > limits["cascade_diff"]
    assert r["state_unchanged"]["sketch_diff"] > limits["sketch_diff"]
    assert r["answer_altered"]["sketch_diff"] > limits["sketch_diff"]
    assert r["answer_altered"]["block_err_bp"] > limits["block_err_bp"]
    assert r["half_left_out"]["uncovered_pct"] > limits["uncovered_pct"]


@pytest.mark.cuda
def test_reference_same_on_card_and_cpu():
    import torch

    from synbench import reference

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    config = json.load(open(os.path.join(ROOT, "synbench", "tests", "data", "tiny.json")))
    traffic = json.load(open(os.path.join(ROOT, "synbench", "traffic", "div01.json")))
    genomes = gen.make_genomes(config, traffic, SEED)
    out = {}
    for dev in ("cpu", "cuda"):
        bloom, bits, occ = reference.cascade(genomes, 24, 0.025, dev)
        out[dev] = (occ, [reference.sketch_tsv(g, 24, *reference.sketch(g, 24, 1000, bloom, bits))
                          for g in genomes])
    assert out["cpu"] == out["cuda"]
