"""The readers of the program's spans inside its stages (read_wait_s,
upload_host_s, synteny_graph_s, synteny_blocks_s, refine_mx_s) on a
time.tsv that carries them, and the stage readers unchanged by them."""

import pytest

from synbench import trace
from synbench.tests.test_synbench_metrics import STAGES, TRACE, _job, _read

# a time.tsv as the program writes it under --benchmark: seven columns,
# the outer stages of STAGES with the spans inside and around them
TIME_TSV = """\
stage\tseconds\tpeak_rss_mb\tcuda_peak_so_far_mb\toverlapped_under\tcalls\tself_s
setup\t0.8000\t900.0\t0.0\t-\t1\t0.8000
read_fasta:g00.fa\t2.0000\t3000.0\t0.0\t-\t1\t2.0000
wait_read:g00.fa\t1.5000\t3000.0\t0.0\tmake_common_bf\t1\t1.5000
read_fasta:g01.fa\t3.0000\t5000.0\t0.0\t-\t1\t3.0000
upload.pack:g00.fa\t0.4000\t5000.0\t0.0\tmake_common_bf\t16\t0.4000
upload.wait:g00.fa\t0.1000\t5000.0\t0.0\tmake_common_bf\t14\t0.1000
wait_read:g01.fa\t0.2500\t5000.0\t0.0\tmake_common_bf\t1\t0.2500
upload.pack:g01.fa\t0.3000\t5000.0\t0.0\tmake_common_bf\t16\t0.3000
make_common_bf\t5.5000\t5200.0\t8000.0\t-\t1\t2.8500
upload.legit:g00.fa\t0.0500\t5200.0\t8000.0\tsketch:g00.fa\t3\t0.0500
sketch:g00.fa\t0.5000\t5200.0\t8000.0\t-\t1\t0.4500
assembly:g00.fa\t0.2000\t5200.0\t8000.0\t-\t1\t0.2000
sketch:g01.fa\t1.5000\t5200.0\t8000.0\t-\t1\t1.5000
assembly:g01.fa\t0.2000\t5200.0\t8000.0\t-\t1\t0.2000
write.sketch_tsv:g00.fa\t1.0000\t6000.0\t8000.0\t-\t1\t1.0000
synteny.filter_common\t0.5000\t6000.0\t8000.0\tsynteny\t1\t0.5000
synteny.graph\t1.0000\t6000.0\t8000.0\tsynteny\t1\t1.0000
synteny.simplify\t0.7000\t6000.0\t8000.0\tsynteny\t1\t0.7000
synteny.filter_global\t0.3000\t6000.0\t8000.0\tsynteny\t1\t0.3000
synteny.paths\t0.2000\t6000.0\t8000.0\tsynteny\t1\t0.2000
synteny.lookup\t0.6000\t6000.0\t8000.0\tsynteny.blocks\t1\t0.6000
synteny.blocks\t0.9000\t6000.0\t8000.0\tsynteny\t1\t0.3000
synteny.indel_minmx\t0.1000\t6000.0\t8000.0\tsynteny\t1\t0.1000
synteny.write_blocks\t0.2000\t6000.0\t8000.0\tsynteny\t1\t0.2000
synteny.condense:w100\t0.5000\t6000.0\t8000.0\tsynteny.new_mx:w100\t2\t0.5000
synteny.resketch:w100\t1.0000\t6000.0\t8000.0\tsynteny.new_mx:w100\t2\t0.9000
synteny.filter_mx:w100\t0.3000\t6000.0\t8000.0\tsynteny.new_mx:w100\t2\t0.3000
synteny.new_mx:w100\t2.0000\t6000.0\t8000.0\tsynteny\t1\t0.2000
synteny.graph:w100\t0.4000\t6000.0\t8000.0\tsynteny\t1\t0.4000
synteny.filter:w100\t0.3000\t6000.0\t8000.0\tsynteny\t1\t0.3000
synteny.paths:w100\t0.1000\t6000.0\t8000.0\tsynteny\t1\t0.1000
synteny.blocks:w100\t0.4000\t6000.0\t8000.0\tsynteny\t1\t0.4000
synteny.indel_minmx:w100\t0.1000\t6000.0\t8000.0\tsynteny\t1\t0.1000
synteny.write_blocks:w100\t0.1000\t6000.0\t8000.0\tsynteny\t1\t0.1000
synteny.new_mx:w10\t1.5000\t6000.0\t8000.0\tsynteny\t1\t1.5000
synteny.graph:w10\t0.6000\t6000.0\t8000.0\tsynteny\t1\t0.6000
synteny.filter:w10\t0.5000\t6000.0\t8000.0\tsynteny\t1\t0.5000
synteny.merge:w10\t0.2000\t6000.0\t8000.0\tsynteny\t1\t0.2000
synteny.write_blocks:w10\t0.3000\t6000.0\t8000.0\tsynteny\t2\t0.3000
synteny.dot_join\t0.0500\t6000.0\t8000.0\tsynteny\t1\t0.0500
synteny\t12.0000\t6000.0\t8000.0\t-\t1\t1.5500
write.dot\t2.0000\t6000.0\t8000.0\t-\t1\t2.0000
finish\t0.3000\t6000.0\t8000.0\t-\t1\t0.3000
"""


def _stages(tsv: str) -> dict:
    """A job's stages as synbench/run.py reads its time.tsv."""
    rows = [line.split("\t") for line in tsv.splitlines()][1:]
    return {r[0]: float(r[1]) for r in rows if len(r) > 1}


SPANS = _stages(TIME_TSV)


def test_fixture_holds_the_outer_stages():
    assert {name: SPANS[name] for name in STAGES} == STAGES


@pytest.mark.parametrize("name,want", [
    ("read_wait_s", 1.5 + 0.25),
    ("upload_host_s", 0.4 + 0.1 + 0.3 + 0.05),
    # filter_common, graph, simplify, filter_global; each round's graph and filter
    ("synteny_graph_s", 0.5 + 1.0 + 0.7 + 0.3 + 0.4 + 0.3 + 0.6 + 0.5),
    # paths, blocks (lookup inside), indel_minmx, write_blocks, merge,
    # dot_join, each round's
    ("synteny_blocks_s", 0.2 + 0.9 + 0.1 + 0.2 + 0.1 + 0.4 + 0.1 + 0.1 + 0.2 + 0.3 + 0.05),
    ("refine_mx_s", 2.0 + 1.5),
])
def test_span_metrics(name, want):
    assert _read(name, [_job(stages=SPANS)]) == pytest.approx(want)
    # averaged over the jobs, as the stage readers are
    more = {k: 2 * v for k, v in SPANS.items()}
    assert _read(name, [_job(stages=SPANS), _job(stages=more)]) == pytest.approx(1.5 * want)
    # a program without the spans (before they were added) gives nothing
    assert _read(name, [_job(stages=STAGES)]) is None


def test_synteny_metrics_leave_nothing_out_twice():
    # the graph, blocks and refinement spans are synteny's children on
    # its thread: together they are all of it but its self_s
    parts = sum(_read(n, [_job(stages=SPANS)]) for n in
                ("synteny_graph_s", "synteny_blocks_s", "refine_mx_s"))
    assert parts == pytest.approx(SPANS["synteny"] - 1.55)


@pytest.mark.parametrize("name", [
    "startup_s", "read_s", "common_bf_s", "sketch_s", "synteny_s", "kernel_roofline",
    "device_idle",
])
def test_existing_readers_unchanged_by_the_spans(name):
    shapes = {"nthash": [[1 << 20, 24]], "winmin": [[1 << 20, 1000]]}
    without = _read(name, [_job(stages=STAGES, shapes=shapes)])
    assert without is not None
    assert _read(name, [_job(stages=SPANS, shapes=shapes)]) == without


def test_idle_gap_named_by_a_sub_span():
    # the spans inside synteny reach the trace's ranges as stages do
    ranges = TRACE["ranges"] + [["stage:synteny.graph", 5000.0, 3000.0],
                                ["stage:write.dot", 5200.0, 3500.0]]
    gaps = trace.idle_gaps(dict(TRACE, ranges=ranges))
    assert gaps[0] == ["synteny.graph < write.dot < synteny", pytest.approx(0.00549)]
