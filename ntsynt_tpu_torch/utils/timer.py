"""Spans of the program's host work, on the unix clock, and their
per-stage sums.

Replacement for the reference's per-rule ``memusg -t`` /
``/usr/bin/time -v`` wrappers (bin/ntsynt_run_pipeline.smk:26-35):
instead of wrapping OS processes we record in-process spans. Each
``StageTimer.stage(name)`` records the span's name, its parent (the
innermost span open on the same thread), its thread, and its start and
end on ``time.time_ns()``: the unix clock that ``torch.profiler``'s
chrome trace uses (its ``baseTimeNanoseconds``), so a job's host work
lines up with a trace of the same job. Spans stay in memory and are
written once, at the end: ``<prefix>.time.tsv``, one row per name, with
the role of the reference's benchmark TSVs (wall seconds + peak memory),
and ``<prefix>.spans.tsv``, one row per span. ``StageTimer.count(name,
value)`` adds to a named counter (how much work a stage had: graph
nodes, paths, minimizers kept), written as ``<prefix>.counters.tsv``.

After ``track_memory`` one sampler thread reads the process RSS every
``sample_interval`` seconds and credits it to every span open at that
moment, on any thread; a span also reads it when it opens and when it
closes, and on a CUDA device reads the caching allocator's peak
(``torch.cuda.max_memory_allocated``) when it closes. The device peak is
never reset here: it is the process-wide high-water since the caller
last called ``torch.cuda.reset_peak_memory_stats``, so a stage's value
is the run's peak up to that stage's end.

Under ``--dev`` (utils.log's verbose switch) each span logs its wall as
it closes.
"""

import contextlib
import os
import threading
import time

from .log import is_verbose, log

_PAGE = os.sysconf("SC_PAGESIZE") if hasattr(os, "sysconf") else 4096


def _rss_bytes() -> int:
    """Current process resident set size (Linux /proc; 0 elsewhere)."""
    try:
        with open("/proc/self/statm", "rb") as fin:
            return int(fin.read().split()[1]) * _PAGE
    except (OSError, IndexError, ValueError):
        return 0


class _Span:
    __slots__ = ("name", "parent", "thread", "start_ns", "end_ns", "rss", "dev")

    def __init__(self, name: str, parent, thread: str, start_ns: int):
        self.name, self.parent, self.thread = name, parent, thread
        self.start_ns, self.end_ns = start_ns, None
        self.rss = self.dev = 0  # bytes: host RSS high-water, device peak at the end


class StageTimer:
    SAMPLER_NAME = "StageTimer.sampler"

    def __init__(self, sample_interval: float = 0.05):
        self.spans = []  # closed spans, in the order they closed
        self.sample_interval = sample_interval
        self.device = None  # set by track_memory
        self.cuda = False
        self._tls = threading.local()  # per-thread stack of open spans
        self._lock = threading.Lock()
        self._open = {}  # id -> span open now, on any thread
        self._sampler = None
        self.counters = {}  # name -> summed value, in the order each was first counted

    def track_memory(self, device) -> None:
        """From now on, record each span's host RSS high-water, and on a
        CUDA ``device`` the allocator's peak at its end."""
        self.device = device
        self.cuda = str(device).startswith("cuda")

    @property
    def stages(self) -> dict:
        """name -> seconds summed over its closed spans, in the order
        each name first closed."""
        out = {}
        for s in self.spans:
            out[s.name] = out.get(s.name, 0.0) + (s.end_ns - s.start_ns) / 1e9
        return out

    def count(self, name: str, value) -> None:
        """Add value to the counter ``name`` (from any thread)."""
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + value

    def _stack(self) -> list:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    @contextlib.contextmanager
    def stage(self, name: str):
        """A span named ``name`` over the ``with`` body."""
        stack = self._stack()
        span = _Span(name, stack[-1] if stack else None, threading.current_thread().name,
                     time.time_ns())
        stack.append(span)
        with self._lock:
            self._open[id(span)] = span
            if self.device is not None:
                span.rss = _rss_bytes()
                if self._sampler is None:
                    self._sampler = threading.Thread(
                        target=self._sample, name=self.SAMPLER_NAME, daemon=True)
                    self._sampler.start()
        try:
            yield
        finally:
            span.end_ns = time.time_ns()
            stack.pop()
            if self.device is not None:
                span.rss = max(span.rss, _rss_bytes())
                if self.cuda:
                    import torch

                    span.dev = torch.cuda.max_memory_allocated(self.device)
            with self._lock:
                del self._open[id(span)]
                self.spans.append(span)
            if is_verbose():
                log(f"  [{name}] {(span.end_ns - span.start_ns) / 1e9:.2f}s", dev_only=True)

    def _sample(self) -> None:
        """The sampler thread: credits the RSS to every open span, and
        ends once no span is open (the next span starts another)."""
        while True:
            time.sleep(self.sample_interval)
            with self._lock:
                if not self._open:
                    self._sampler = None
                    return
                rss = _rss_bytes()
                for span in self._open.values():
                    span.rss = max(span.rss, rss)

    def _snapshot(self):
        """[(span, end ns)] of every span, those still open ending now."""
        now = time.time_ns()
        with self._lock:
            closed = [(s, s.end_ns) for s in self.spans]
            still = list(self._open.values())
        if self.device is not None and still:
            rss = _rss_bytes()
            for s in still:
                s.rss = max(s.rss, rss)
                if self.cuda:
                    import torch

                    s.dev = torch.cuda.max_memory_allocated(self.device)
        return closed + [(s, now) for s in still]

    def write_tsv(self, path: str, spans_path: str | None = None) -> None:
        """time.tsv at ``path``: one row per name (the order each first
        closed; names still open last), its seconds, host RSS and device
        peaks in MB, the span it first ran under, how many spans it sums
        (``calls``), and the seconds of those that their child spans on
        the same thread do not cover (``self_s``). With ``spans_path``
        also spans.tsv there: one row per span by start, its parent and
        thread, start and end in unix nanoseconds. A span still open is
        counted up to now, in both files alike."""
        snap = self._snapshot()
        covered = {}
        for s, end in snap:
            if s.parent is not None:
                covered[id(s.parent)] = covered.get(id(s.parent), 0) + end - s.start_ns
        rows = {}
        for s, end in snap:
            r = rows.setdefault(s.name, [0, 0, 0, 0, "-", 0])  # ns, rss, dev, self ns, under, calls
            r[0] += end - s.start_ns
            r[1], r[2] = max(r[1], s.rss), max(r[2], s.dev)
            r[3] += end - s.start_ns - covered.get(id(s), 0)
            if r[4] == "-" and s.parent is not None:
                r[4] = s.parent.name
            r[5] += 1
        with open(path, "w", encoding="utf-8") as fout:
            fout.write("stage\tseconds\tpeak_rss_mb\tcuda_peak_so_far_mb\toverlapped_under"
                       "\tcalls\tself_s\n")
            for name, (ns, rss, dev, self_ns, under, calls) in rows.items():
                fout.write(f"{name}\t{ns / 1e9:.4f}\t{rss / 1e6:.1f}\t{dev / 1e6:.1f}\t{under}"
                           f"\t{calls}\t{self_ns / 1e9:.4f}\n")
        if spans_path is None:
            return
        with open(spans_path, "w", encoding="utf-8") as fout:
            fout.write("name\tparent\tthread\tstart_ns\tend_ns\n")
            for s, end in sorted(snap, key=lambda se: se[0].start_ns):
                parent = "-" if s.parent is None else s.parent.name
                fout.write(f"{s.name}\t{parent}\t{s.thread}\t{s.start_ns}\t{end}\n")

    def write_counters(self, path: str) -> None:
        """counters.tsv at ``path``: one row per counter (name, value),
        in the order each was first counted; no file when nothing was
        counted."""
        with self._lock:
            rows = list(self.counters.items())
        if not rows:
            return
        with open(path, "w", encoding="utf-8") as fout:
            fout.write("name\tvalue\n")
            fout.writelines(f"{name}\t{value}\n" for name, value in rows)
