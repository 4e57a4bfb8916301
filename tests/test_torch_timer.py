"""The port's StageTimer (utils/timer.py) and the spans the pipeline
records with it: parents per thread, the unix clock, time.tsv's calls and
self_s, spans.tsv against time.tsv, one RSS sampler thread, and a CLI run
seen through a wrapper of StageTimer.stage like the benchmark's; its
counters (StageTimer.count) and counters.tsv."""

import sys
import threading
import time

import numpy as np
import pytest

from ntsynt_tpu_torch.cli import main as torch_main
from ntsynt_tpu_torch.core import synteny
from ntsynt_tpu_torch.io import fasta as fio
from ntsynt_tpu_torch.utils import StageTimer


def _read_tsv(path):
    lines = path.read_text().splitlines()
    head = lines[0].split("\t")
    return head, [dict(zip(head, line.split("\t"))) for line in lines[1:]]


def _samplers():
    return [t for t in threading.enumerate() if t.name == StageTimer.SAMPLER_NAME]


def test_parents_per_thread():
    timer = StageTimer()
    started, release = threading.Event(), threading.Event()

    def prefetch():
        with timer.stage("read"):
            with timer.stage("read.inner"):
                started.set()
                release.wait(10)

    with timer.stage("outer"):
        t = threading.Thread(target=prefetch, name="prefetch")
        t.start()
        assert started.wait(10)
        with timer.stage("wait"):  # opens while the other thread's spans are open
            release.set()
            t.join(10)
    assert not t.is_alive()
    by = {s.name: s for s in timer.spans}
    assert by["read"].parent is None and by["read"].thread == "prefetch"
    assert by["read.inner"].parent is by["read"]
    assert by["wait"].parent is by["outer"] and by["wait"].thread == "MainThread"
    assert by["outer"].parent is None


def test_unix_clock():
    timer = StageTimer()
    before = time.time_ns()
    with timer.stage("a"):
        time.sleep(0.01)
    after = time.time_ns()
    (s,) = timer.spans
    assert before <= s.start_ns < s.end_ns <= after
    assert s.end_ns - s.start_ns >= 10_000_000
    assert timer.stages == {"a": pytest.approx((s.end_ns - s.start_ns) / 1e9)}


def test_calls_self_and_spans_tsv(tmp_path):
    timer = StageTimer()
    with timer.stage("top"):
        for _ in range(3):
            with timer.stage("child"):
                time.sleep(0.005)
        time.sleep(0.01)
    held = []

    def side():  # a span left open on a thread of its own
        held.append(timer.stage("side"))
        held[-1].__enter__()

    other = threading.Thread(target=side)
    with timer.stage("last"):  # still open when written: counted up to then
        other.start()
        other.join(10)
        timer.write_tsv(str(tmp_path / "t.time.tsv"), str(tmp_path / "t.spans.tsv"))
    head, rows = _read_tsv(tmp_path / "t.time.tsv")
    assert head == ["stage", "seconds", "peak_rss_mb", "cuda_peak_so_far_mb", "overlapped_under",
                    "calls", "self_s"]
    row = {r["stage"]: r for r in rows}
    assert [r["stage"] for r in rows] == ["child", "top", "last", "side"]
    assert row["child"]["calls"] == "3" and row["top"]["calls"] == "1"
    assert row["child"]["overlapped_under"] == "top" and row["top"]["overlapped_under"] == "-"
    top, child = float(row["top"]["seconds"]), float(row["child"]["seconds"])
    assert child >= 0.015 and top >= child + 0.01
    assert float(row["top"]["self_s"]) == pytest.approx(top - child, abs=2e-4)
    assert row["child"]["self_s"] == row["child"]["seconds"]
    # the span open on another thread is no child of "last"
    assert row["last"]["self_s"] == row["last"]["seconds"]

    head, spans = _read_tsv(tmp_path / "t.spans.tsv")
    assert head == ["name", "parent", "thread", "start_ns", "end_ns"]
    starts = [int(s["start_ns"]) for s in spans]
    assert starts == sorted(starts) and len(spans) == 6
    sums = {}
    for s in spans:
        sums[s["name"]] = sums.get(s["name"], 0) + int(s["end_ns"]) - int(s["start_ns"])
    assert sums.keys() == row.keys()
    for name, ns in sums.items():
        assert float(row[name]["seconds"]) == pytest.approx(ns / 1e9, abs=5e-5), name
    assert {s["parent"] for s in spans if s["name"] == "child"} == {"top"}


def test_one_sampler_thread_however_deep():
    timer = StageTimer(sample_interval=0.005)
    timer.track_memory("cpu")
    inside = threading.Event()
    release = threading.Event()

    def nest(depth, tag):
        if depth == 0:
            inside.set()
            release.wait(10)
            return
        with timer.stage(f"{tag}{depth}"):
            nest(depth - 1, tag)

    t = threading.Thread(target=nest, args=(4, "side"))
    with timer.stage("outer"):
        with timer.stage("mid"):
            t.start()
            assert inside.wait(10)
            with timer.stage("deep"):
                ballast = np.ones(64 << 20, np.uint8)  # 64 MB touched while open
                time.sleep(0.05)
                assert len(_samplers()) == 1
                del ballast
            release.set()
            t.join(10)
    assert not t.is_alive()
    for s in _samplers():
        s.join(2)
    assert _samplers() == []  # it ends once no span is open
    by = {s.name: s for s in timer.spans}
    assert by["deep"].rss >= 64 << 20
    assert by["outer"].rss >= by["deep"].rss and by["mid"].rss >= by["deep"].rss
    assert all(s.rss > 0 for s in timer.spans)
    # a later span starts the sampler again
    with timer.stage("again"):
        assert len(_samplers()) == 1


# every family of spans the pipeline records, and the thread it runs on
FAMILIES = {
    "setup": "MainThread", "finish": "MainThread", "make_common_bf": "MainThread",
    "bf.level:": "MainThread", "synteny.join:": "MainThread",
    "read_fasta:": "read_prefetch", "wait_read:": "MainThread", "sketch:": "MainThread",
    "upload.pack:": "MainThread", "upload.legit:": "MainThread", "synteny": "MainThread",
    "synteny.filter_common": "MainThread", "synteny.graph": "MainThread",
    "synteny.simplify": "MainThread", "synteny.filter_global": "MainThread",
    "synteny.graph:w": "MainThread", "synteny.filter:w": "MainThread",
    "synteny.paths": "MainThread", "synteny.blocks": "MainThread",
    "synteny.lookup": "MainThread", "synteny.indel_minmx": "MainThread",
    "synteny.write_blocks": "MainThread", "synteny.merge:w": "MainThread",
    "synteny.dot_join": "MainThread", "synteny.new_mx:w": "MainThread",
    "synteny.condense:w": "MainThread", "synteny.resketch:w": "MainThread",
    "synteny.filter_mx:w": "MainThread", "assembly:": "MainThread",
    "write.sketch_tsv:": "write.sketch_tsv:",
    "write.dot": "write.dot",
}
# upload.wait:* needs a CUDA copy to wait on; write.bf a full .bf artifact,
# which the CLI never writes


def _pair(tmp_path):
    """Two 300 kb genomes, the second inverted at 100-150 kb; their paths."""
    rng = np.random.default_rng(3)
    a = rng.integers(0, 4, 300_000).astype(np.uint8)
    b = a.copy()
    b[100_000:150_000] = 3 - b[100_000:150_000][::-1]
    dec = np.array(list("ACGT"))
    paths = []
    for name, g in (("ta.fa", a), ("tb.fa", b)):
        s = "".join(dec[g])
        (tmp_path / name).write_text(">c1\n" + "\n".join(s[i:i + 70] for i in range(0, len(s), 70))
                                     + "\n")
        paths.append(str(tmp_path / name))
    return paths


def test_count_sums_a_name_counted_twice(tmp_path):
    timer = StageTimer()
    timer.count("nodes", 3)
    timer.count("edges", 2)
    timer.count("nodes", 4)
    assert timer.counters == {"nodes": 7, "edges": 2}
    timer.write_counters(str(tmp_path / "t.counters.tsv"))
    assert (tmp_path / "t.counters.tsv").read_text() == "name\tvalue\nnodes\t7\nedges\t2\n"


def test_count_from_many_threads():
    timer = StageTimer()

    def add():
        for _ in range(2000):
            timer.count("n", 1)

    threads = [threading.Thread(target=add) for _ in range(8)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)  # switch threads often: a lost update would show
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(10)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert timer.counters == {"n": 16000}


def test_no_counters_no_file(tmp_path):
    timer = StageTimer()
    with timer.stage("a"):
        pass
    timer.write_counters(str(tmp_path / "t.counters.tsv"))
    assert not (tmp_path / "t.counters.tsv").exists()


@pytest.mark.parametrize("benchmark", [True, False])
def test_counters_tsv_only_with_benchmark(tmp_path, monkeypatch, benchmark):
    paths = _pair(tmp_path)
    monkeypatch.chdir(tmp_path)
    assert torch_main([*paths, "-d", "1", "-w", "250", "--device", "cpu", "-p", "t",
                       *(["--benchmark"] if benchmark else [])]) == 0
    path = tmp_path / "t.counters.tsv"
    assert path.exists() == benchmark and (tmp_path / "t.time.tsv").exists() == benchmark
    if not benchmark:
        return
    head, rows = _read_tsv(path)
    assert head == ["name", "value"]
    got = {r["name"]: int(r["value"]) for r in rows}
    rounds = ["", ":w250", ":w100"]  # -d 1: --w_rounds 250 100
    want = {f"synteny.common_mx:{g}" for g in ("ta.fa", "tb.fa")}
    want |= {f"synteny.{n}{r}" for n in ("nodes", "edges", "paths", "blocks") for r in rounds}
    want |= {f"synteny.new_mx:{r[1:]}:{g}" for r in rounds[1:] for g in ("ta.fa", "tb.fa")}
    assert set(got) == want
    assert all(v > 0 for v in got.values()), got
    # a path holds at least two nodes; a path gives at most one block
    assert got["synteny.nodes"] >= 2 * got["synteny.paths"]
    assert got["synteny.paths"] >= got["synteny.blocks"]
    # the common filter keeps the same minimizers in both assemblies
    assert got["synteny.common_mx:ta.fa"] == got["synteny.common_mx:tb.fa"]
    blocks = (tmp_path / "t.synteny_blocks.tsv").read_text().splitlines()
    assert len({r.split("\t")[0] for r in blocks}) <= got["synteny.blocks:w100"]


def test_cli_spans_through_the_benchmark_wrapper(tmp_path, monkeypatch):
    from synbench.job import _record_stages

    paths = _pair(tmp_path)
    real_read = fio.read_fasta

    def slow_read(*args, **kw):  # the main thread reaches the first genome before it is read
        time.sleep(0.2)
        return real_read(*args, **kw)

    monkeypatch.setattr(fio, "read_fasta", slow_read)
    monkeypatch.setattr(synteny, "BATCH_LOOKUP", 1)  # every lookup a batch join
    monkeypatch.setattr(StageTimer, "stage", StageTimer.stage)  # restored after the test
    seen = []
    _record_stages(seen)
    monkeypatch.chdir(tmp_path)
    assert torch_main([*paths, "-d", "1", "-w", "250", "--device", "cpu", "--benchmark",
                       "-p", "t"]) == 0

    _, rows = _read_tsv(tmp_path / "t.time.tsv")
    _, spans = _read_tsv(tmp_path / "t.spans.tsv")
    names = {r["stage"] for r in rows}
    assert len(spans) < 400
    # the wrapper saw every span, with the same walls
    assert sorted(n for n, _, _ in seen) == sorted(s["name"] for s in spans)
    for family, thread in FAMILIES.items():
        match = [s for s in spans if s["name"] == family
                 or (family[-1] in ":w" and s["name"].startswith(family))]
        assert match, family
        assert all(s["thread"].startswith(thread) for s in match), (family, match)
    # the sub-spans cover at least 90% of synteny, and no read or sketch
    # name was added to what read_s and sketch_s match
    row = {r["stage"]: r for r in rows}
    assert float(row["synteny"]["self_s"]) <= 0.1 * float(row["synteny"]["seconds"])
    assert {n for n in names if n.startswith(("read_fasta:", "sketch:"))} == {
        "read_fasta:ta.fa", "read_fasta:tb.fa", "sketch:ta.fa", "sketch:tb.fa"}
    # setup, the stages and finish cover the call between setup's start
    # and finish's end on the main thread
    main = sorted((int(s["start_ns"]), int(s["end_ns"])) for s in spans
                  if s["parent"] == "-" and s["thread"] == "MainThread")
    gaps = sum(max(0, s - e) for (_, e), (s, _) in zip(main, main[1:]))
    assert gaps <= 0.03 * (main[-1][1] - main[0][0])
