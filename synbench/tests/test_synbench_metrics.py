"""Each per-layer metric from a fixed time.tsv and profiler-event
fixture, and the interval union behind device_idle."""

import importlib

import pytest

from synbench import trace

STAGES = {"read_fasta:g00.fa": 2.0, "read_fasta:g01.fa": 3.0, "make_common_bf": 5.5,
          "sketch:g00.fa": 0.5, "sketch:g01.fa": 1.5, "synteny": 12.0}
# a job's call from t=0 us to 10000 us; device work 0-1000, 500-2000
# (overlapping), 4000-4500 and 9990-10010 (a little past the call's end)
TRACE = {
    "ranges": [["synbench.job", 0.0, 10000.0], ["stage:synteny", 5000.0, 4000.0],
               ["stage:make_common_bf", 0.0, 4500.0]],
    "device": [["kernel", "nthash_kernel(unsigned char const*, long)", 0.0, 1000.0],
               ["kernel", "winmin_kernel(long long const*, long)", 500.0, 1500.0],
               ["gpu_memcpy", "Memcpy HtoD", 4000.0, 500.0],
               ["kernel", "compact_kernel(long long const*)", 9990.0, 20.0]],
}


def _read(name, jobs):
    return importlib.import_module(f"synbench.metrics.{name}").read(jobs)


def _job(stages=STAGES, tr=TRACE, shapes=None, rate=3.35e12):
    return {"stages": stages, "hbm_bytes_per_s": rate,
            "result": {"startup_s": 7.5, "trace": tr, "shapes": shapes or {}}}


@pytest.mark.parametrize("name,want", [
    ("read_s", 5.0), ("common_bf_s", 5.5), ("sketch_s", 2.0), ("synteny_s", 12.0),
    ("startup_s", 7.5),
])
def test_stage_metrics(name, want):
    assert _read(name, [_job()]) == pytest.approx(want)


def test_stage_metrics_average_over_jobs():
    other = dict(STAGES, synteny=14.0)
    assert _read("synteny_s", [_job(), _job(stages=other)]) == pytest.approx(13.0)
    assert _read("synteny_s", [{"stages": {}, "result": {}}]) is None


def test_interval_union_and_idle():
    iv = trace.device_intervals(TRACE, 0.0, 10000.0)
    assert iv == [[0.0, 2000.0], [4000.0, 4500.0], [9990.0, 10000.0]]
    assert trace.busy_and_window(TRACE) == (2510.0, 10000.0)
    assert _read("device_idle", [_job()]) == pytest.approx(74.9)


def test_idle_gaps_named_by_stage():
    gaps = trace.idle_gaps(TRACE)
    assert gaps[0] == ["synteny", pytest.approx(0.00549)]  # 4500-9990
    assert gaps[1] == ["make_common_bf", pytest.approx(0.002)]  # 2000-4000
    tr = dict(TRACE, ranges=TRACE["ranges"][:1])
    assert trace.idle_gaps(tr)[0] == ["host", pytest.approx(0.00549)]


def test_no_idle_share_where_the_clocks_disagree():
    # the device's events shifted past the call's end by more than 1% of
    # their time: the host's clock and the device's do not line up
    late = [[c, n, ts + 9000.0, d] for c, n, ts, d in TRACE["device"]]
    tr = dict(TRACE, device=late)
    assert trace.busy_and_window(tr) is None
    assert _read("device_idle", [_job(tr=tr)]) is None


def test_device_idle_without_device_activity():
    tr = dict(TRACE, device=[])
    assert _read("device_idle", [_job(tr=tr)]) is None
    assert _read("kernel_roofline", [_job(tr=tr, shapes={"nthash": [[10, 4]]})]) is None


def test_kernel_roofline():
    # K1: 2^20 k-mers of k=24 -> (2^20 + 23) + 17 * 2^20 bytes over 1000 us
    # K2: 2^20 keys at w=1000 -> 8 * 2^20 + 16 * (2^20 - 999) bytes over 1500 us
    shapes = {"nthash": [[1 << 20, 24]], "winmin": [[1 << 20, 1000]]}
    rate = 3.35e12
    tr = dict(TRACE, device=TRACE["device"][:2])
    bound = ((1 << 20) + 23 + 17 * (1 << 20) + 8 * (1 << 20) + 16 * ((1 << 20) - 999)) / rate
    want = 100.0 * bound / 2500e-6
    assert _read("kernel_roofline", [_job(tr=tr, shapes=shapes, rate=rate)]) == \
        pytest.approx(want)
    assert _read("kernel_roofline", [_job(tr=tr, shapes=shapes, rate=None)]) is None


def test_device_ops_by_name():
    ops = trace.device_ops([TRACE])
    assert ops[0] == ["winmin_kernel", pytest.approx(0.0015)]
    assert ["gpu_memcpy Memcpy HtoD", pytest.approx(0.0005)] in ops
