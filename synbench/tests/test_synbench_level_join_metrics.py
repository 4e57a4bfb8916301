"""The readers of the cascade's per-level spans (bf_level_s) and of host
synteny's per-assembly joins (synteny_join_s) on a four-genome time.tsv
that carries them, and every other reader unchanged by those rows."""

import pytest

from synbench.tests.test_synbench_metrics import STAGES, _job, _read
from synbench.tests.test_synbench_span_metrics import SPANS, TIME_TSV, _stages

# rows a four-genome job adds to time.tsv: one bf.level:<g> a genome
# inside make_common_bf (its read wait and upload spans nest inside it),
# and one synteny.join:<a> an assembly inside synteny.lookup
LEVELS = {"bf.level:g00.fa": 1.2, "bf.level:g01.fa": 0.8, "bf.level:g02.fa": 0.6,
          "bf.level:g03.fa": 0.6}
JOINS = {"synteny.join:g03.fa": 0.10, "synteny.join:g02.fa": 0.12,
         "synteny.join:g01.fa": 0.14, "synteny.join:g00.fa": 0.16}
ROWS = "".join(f"{name}\t{s:.4f}\t5000.0\t8000.0\t{under}\t3\t{s:.4f}\n"
               for rows, under in ((LEVELS, "make_common_bf"), (JOINS, "synteny.lookup"))
               for name, s in rows.items())
WITH_NEW = _stages(TIME_TSV + ROWS)


def test_fixture_carries_the_new_rows():
    assert {n: WITH_NEW[n] for n in LEVELS} == LEVELS
    assert {n: WITH_NEW[n] for n in JOINS} == JOINS


@pytest.mark.parametrize("name,want", [
    ("bf_level_s", (1.2 + 0.8 + 0.6 + 0.6) / 4),  # the mean over the levels
    ("synteny_join_s", 0.10 + 0.12 + 0.14 + 0.16),  # the sum over the assemblies
])
def test_new_readers(name, want):
    assert _read(name, [_job(stages=WITH_NEW)]) == pytest.approx(want)
    # averaged over the jobs, as the other stage readers are
    more = {k: 3 * v for k, v in WITH_NEW.items()}
    assert _read(name, [_job(stages=WITH_NEW), _job(stages=more)]) == pytest.approx(2 * want)
    # a job without the spans (a program before they were added) gives nothing
    assert _read(name, [_job(stages=SPANS)]) is None
    assert _read(name, [_job(stages=STAGES)]) is None


def test_level_mean_per_job_then_over_jobs():
    # a two-level job and a four-level job: each job's own mean, then theirs
    two = dict(SPANS, **{"bf.level:g00.fa": 1.0, "bf.level:g01.fa": 3.0})
    assert _read("bf_level_s", [_job(stages=two), _job(stages=WITH_NEW)]) == pytest.approx(
        (2.0 + 0.8) / 2)
    # jobs without the spans are left out of the mean
    assert _read("bf_level_s", [_job(stages=two), _job(stages=SPANS)]) == pytest.approx(2.0)


@pytest.mark.parametrize("name", [
    "startup_s", "read_s", "common_bf_s", "sketch_s", "synteny_s", "kernel_roofline",
    "device_idle", "read_wait_s", "upload_host_s", "synteny_graph_s", "synteny_blocks_s",
    "refine_mx_s",
])
def test_existing_readers_unchanged_by_the_new_rows(name):
    shapes = {"nthash": [[1 << 20, 24]], "winmin": [[1 << 20, 1000]]}
    without = _read(name, [_job(stages=SPANS, shapes=shapes)])
    assert without is not None
    assert _read(name, [_job(stages=WITH_NEW, shapes=shapes)]) == without
