"""Per-stage wall-clock + peak-memory benchmarking.

Replacement for the reference's per-rule ``memusg -t`` /
``/usr/bin/time -v`` wrappers (bin/ntsynt_run_pipeline.smk:26-35):
instead of wrapping OS processes we time in-process stages, sample the
process RSS high-water while each stage runs, read the CUDA caching
allocator's peak (``torch.cuda.max_memory_allocated``) at the end of
each stage, and emit a ``<prefix>.time.tsv`` summary with the same role
as the reference's benchmark TSVs (wall seconds + peak memory).

The device peak is never reset here: it is the process-wide high-water
since the caller last called ``torch.cuda.reset_peak_memory_stats``, so
a stage's value is the run's peak up to that stage's end, and the last
stage's value is the run's peak.
"""

import contextlib
import json
import os
import threading
import time
from collections import OrderedDict

_PAGE = os.sysconf("SC_PAGESIZE") if hasattr(os, "sysconf") else 4096


def _rss_bytes() -> int:
    """Current process resident set size (Linux /proc; 0 elsewhere)."""
    try:
        with open("/proc/self/statm", "rb") as fin:
            return int(fin.read().split()[1]) * _PAGE
    except (OSError, IndexError, ValueError):
        return 0


class _MemSampler:
    """Background host-RSS high-water sampler for one stage."""

    def __init__(self, interval: float):
        self.interval = interval
        self.peak_rss = _rss_bytes()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        while not self._stop.wait(self.interval):
            self.peak_rss = max(self.peak_rss, _rss_bytes())

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=2.0)
        self.peak_rss = max(self.peak_rss, _rss_bytes())


class StageTimer:
    def __init__(self, device="cpu", sample_interval: float = 0.05,
                 sample_memory: bool = True):
        """sample_memory=False disables the background RSS sampler
        thread and the device peak reads (per-stage walls only).
        ``device`` is the torch device the run computes on; device
        memory is read only when it is a CUDA device."""
        self.stages = OrderedDict()  # name -> wall seconds
        self.peak_rss = OrderedDict()  # name -> bytes (host RSS high-water)
        # name -> bytes: torch.cuda.max_memory_allocated at the stage's end
        self.peak_dev = OrderedDict()
        # name -> enclosing stage for stages that ran nested inside
        # another (e.g. a genome read triggered from inside the BF
        # cascade): their wall is already counted in the parent
        self.nested_in = OrderedDict()
        # per-THREAD stacks of currently-open stages: background reads
        # (pipeline genome prefetch) time their own stages concurrently
        # with the main thread's, and must not inherit its nesting
        self._tls = threading.local()
        self.sample_interval = sample_interval
        self.sample_memory = sample_memory
        self.device = device
        self.cuda = str(device).startswith("cuda")

    @property
    def _active(self):
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        if self._active and name not in self.nested_in:
            self.nested_in[name] = self._active[-1]
        self._active.append(name)
        if not self.sample_memory:
            try:
                yield
            finally:
                self._active.pop()
                dt = time.perf_counter() - t0
                self.stages[name] = self.stages.get(name, 0.0) + dt
            return
        try:
            with _MemSampler(self.sample_interval) as mem:
                try:
                    yield
                finally:
                    dt = time.perf_counter() - t0
                    self.stages[name] = self.stages.get(name, 0.0) + dt
        finally:
            self._active.pop()
        self.peak_rss[name] = max(self.peak_rss.get(name, 0), mem.peak_rss)
        if self.cuda:
            import torch

            self.peak_dev[name] = max(
                self.peak_dev.get(name, 0), torch.cuda.max_memory_allocated(self.device)
            )

    def write_tsv(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as fout:
            fout.write("stage\tseconds\tpeak_rss_mb\tcuda_peak_so_far_mb\toverlapped_under\n")
            for name, secs in self.stages.items():
                rss = self.peak_rss.get(name, 0) / 1e6
                dev = self.peak_dev.get(name, 0) / 1e6
                under = self.nested_in.get(name, "-")
                fout.write(f"{name}\t{secs:.4f}\t{rss:.1f}\t{dev:.1f}\t{under}\n")

    def as_json(self) -> str:
        out = {}
        for k, v in self.stages.items():
            d = {
                "s": round(v, 4),
                "rss_mb": round(self.peak_rss.get(k, 0) / 1e6, 1),
                "cuda_peak_so_far_mb": round(self.peak_dev.get(k, 0) / 1e6, 1),
            }
            if k in self.nested_in:
                d["under"] = self.nested_in[k]
            out[k] = d
        return json.dumps(out)
