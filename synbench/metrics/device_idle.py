"""device_idle: percent of the profiled cli.main calls in which no
kernel, copy or set ran on the card: 1 - (union of the profiler's device
intervals) / (the calls' wall), over every traced job."""

from .. import trace


def read(jobs):
    busy = window = 0.0
    for job in jobs:
        tr = job["result"].get("trace")
        bw = trace.busy_and_window(tr) if tr else None
        if bw is None:
            continue
        busy, window = busy + bw[0], window + bw[1]
    if window <= 0 or busy <= 0:
        return None  # no device activity traced: nothing to read
    return 100.0 * (1.0 - busy / window)
