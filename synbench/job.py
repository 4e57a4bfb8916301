"""One CLI job in a process of its own, as a user runs it.

    python -m synbench.job --out RESULT.json [--trace] -- <CLI arguments>

Runs ``ntsynt_tpu_torch.cli.main(<CLI arguments>)`` (what ``python -m
ntsynt_tpu_torch`` runs) in the current directory and writes RESULT.json:
the seconds from the process's start to the port imported and CUDA
initialised (``startup_s``), the call's own wall, the host RSS high-water
of the process (sampled every 50 ms from /proc/self/statm), the CUDA
allocator's peaks, each kernel's launch sizes (``_kernels.SHAPES``), the
kernel library's build, the card's name, and the top-level names of
forbidden modules found loaded. With --trace on the card the call runs
under torch.profiler with CUDA activity alone (no host op is recorded, so
the call runs at nearly its untraced speed), each of the program's stage
spans is timed on the host's clock, and RESULT.json gets the device
events and those spans, in microseconds from the call's start.
"""

import contextlib
import json
import os
import sys
import threading
import time


def _process_age_s() -> float:
    """Seconds since this process started (Linux /proc; 10 ms steps)."""
    with open("/proc/self/stat") as fin:
        start_ticks = int(fin.read().rpartition(")")[2].split()[19])
    with open("/proc/uptime") as fin:
        uptime = float(fin.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


FORBIDDEN = ("jax", "jaxlib", "flax", "ntsynt_tpu")
_PAGE = os.sysconf("SC_PAGESIZE")


def rss_bytes() -> int:
    with open("/proc/self/statm", "rb") as fin:
        return int(fin.read().split()[1]) * _PAGE


class RssSampler:
    """Host RSS high-water, sampled on a thread of its own (the
    arithmetic of the program's utils/timer._MemSampler)."""

    def __init__(self, interval: float = 0.05):
        self.interval = interval
        self.peak = rss_bytes()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        while not self._stop.wait(self.interval):
            self.peak = max(self.peak, rss_bytes())

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, rss_bytes())


def forbidden_loaded() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _trace_events(path: str, t0_ns: int, call_ns: int, spans: list) -> dict:
    """The call's range, the program's stage spans and the device events
    (kernels, copies, sets) of a chrome trace, in microseconds from the
    call's start. The trace's times are on the unix clock (from its
    ``baseTimeNanoseconds``), as time.time_ns() is."""
    with open(path) as fin:
        trace = json.load(fin)
    base = int(trace.get("baseTimeNanoseconds", 0))
    dev = []
    for ev in trace.get("traceEvents", []):
        cat = ev.get("cat", "")
        if ev.get("ph") == "X" and cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            ts = (base + float(ev["ts"]) * 1e3 - t0_ns) / 1e3
            dev.append([cat, ev.get("name", ""), ts, float(ev.get("dur", 0.0))])
    ranges = [["synbench.job", 0.0, call_ns / 1e3]]
    ranges += [[f"stage:{name}", (s - t0_ns) / 1e3, (e - s) / 1e3] for name, s, e in spans]
    return {"device": dev, "ranges": ranges}


def _record_stages(spans: list):
    """Time each of the program's stage spans on the unix clock:
    [name, start ns, end ns] appended to spans."""
    from ntsynt_tpu_torch.utils.timer import StageTimer

    inner = StageTimer.stage

    @contextlib.contextmanager
    def stage(self, name):
        t0 = time.time_ns()
        try:
            with inner(self, name):
                yield
        finally:
            spans.append([name, t0, time.time_ns()])

    StageTimer.stage = stage


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    cut = argv.index("--")
    opts, cli_argv = argv[:cut], argv[cut + 1:]
    out_path = opts[opts.index("--out") + 1]
    trace = "--trace" in opts
    cuda = "--device" not in cli_argv or cli_argv[cli_argv.index("--device") + 1] != "cpu"

    import torch

    from ntsynt_tpu_torch import cli
    from ntsynt_tpu_torch.ops import _kernels

    if cuda:
        torch.cuda.init()
    res = {"startup_s": _process_age_s()}
    prof, spans = None, []
    if trace and cuda:
        _record_stages(spans)
        prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
        prof.__enter__()
    with RssSampler() as mem:
        t0_ns = time.time_ns()
        rc = cli.main(cli_argv)
        if cuda:
            torch.cuda.synchronize()
        call_ns = time.time_ns() - t0_ns
    res["call_s"] = call_ns / 1e9
    if prof is not None:
        prof.__exit__(None, None, None)
        trace_path = os.path.abspath("synbench.trace.json")
        prof.export_chrome_trace(trace_path)
        res["trace"] = _trace_events(trace_path, t0_ns, call_ns, spans)
        os.remove(trace_path)
    res.update(
        rc=rc,
        peak_rss_bytes=mem.peak,
        device_peak_allocated=torch.cuda.max_memory_allocated() if cuda else 0,
        device_peak_reserved=torch.cuda.max_memory_reserved() if cuda else 0,
        shapes={name: [list(s) for s in v] for name, v in _kernels.SHAPES.items()},
        build=dict(kernels=_kernels.BUILD_INFO, host=_kernels.HOST_BUILD_INFO),
        device_name=torch.cuda.get_device_name(0) if cuda else "cpu",
        forbidden=forbidden_loaded(),
    )
    with open(out_path, "w") as fout:
        json.dump(res, fout)
    return 0 if rc in (0, None) and not res["forbidden"] else 1


if __name__ == "__main__":
    sys.exit(main())
