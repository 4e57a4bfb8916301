"""Reductions of a traced job's profiler events (job.py's ``trace``):
device intervals, their union inside the job's call, the idle gaps and
the program's stages open over each. Times in microseconds from the
call's start."""

import re


def job_range(trace: dict):
    """(start, end) of the profiled cli.main call, or None."""
    for name, ts, dur in trace["ranges"]:
        if name == "synbench.job":
            return ts, ts + dur
    return None


def device_intervals(trace: dict, lo: float, hi: float):
    """Sorted, merged device intervals (kernels, copies, sets) clipped to
    [lo, hi)."""
    iv = sorted((max(ts, lo), min(ts + dur, hi)) for _, _, ts, dur in trace["device"])
    merged = []
    for s, e in iv:
        if e <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def busy_and_window(trace: dict):
    """(device-busy us, call us) of one job; None without a call range, or
    where under 99% of the device time lies inside the call: the device's
    clock and the host's then disagree, and no idle share can be read."""
    rng = job_range(trace)
    if rng is None:
        return None
    busy = sum(e - s for s, e in device_intervals(trace, *rng))
    total = sum(e - s for s, e in device_intervals(trace, float("-inf"), float("inf")))
    if busy < 0.99 * total:
        return None
    return busy, rng[1] - rng[0]


def short_name(name: str) -> str:
    """A kernel's function name without its argument list."""
    name = re.sub(r"^void |\(anonymous namespace\)::", "", name)
    return name.split("(")[0].strip()[:120]


def _host_label(trace: dict, s: float, e: float) -> str:
    """The program's stages open over [s, e), innermost first, else
    "host"."""
    mid = (s + e) / 2
    stages = sorted((dur, name[6:]) for name, ts, dur in trace["ranges"]
                    if name.startswith("stage:") and ts <= mid < ts + dur)
    return " < ".join(name for _, name in stages) or "host"


def idle_gaps(trace: dict, top: int = 10):
    """The longest gaps between device intervals inside the call, as
    [host label, seconds]."""
    rng = job_range(trace)
    if rng is None:
        return []
    lo, hi = rng
    gaps, at = [], lo
    for s, e in device_intervals(trace, lo, hi) + [[hi, hi]]:
        if s > at:
            gaps.append((s - at, at, s))
        at = max(at, e)
    gaps.sort(reverse=True)
    return [[_host_label(trace, s, e), d / 1e6] for d, s, e in gaps[:top]]


def device_ops(traces, top: int = 10):
    """The device operations that took most time over the traces, as
    [name, seconds]."""
    tot = {}
    for trace in traces:
        for cat, name, _, dur in trace["device"]:
            key = short_name(name) if cat == "kernel" else f"{cat} {name}"[:120]
            tot[key] = tot.get(key, 0.0) + dur
    return [[k, v / 1e6] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:top]]
