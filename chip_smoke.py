#!/usr/bin/env python3
"""Drive ntsynt_tpu_torch on one CUDA card and check it end to end.

    python3 chip_smoke.py

Phases, each printing one JSON line with its elapsed seconds:
  1. device: torch's device name and nvidia-smi's name and power limit;
  2. build: one nvcc call compiles ntsynt_tpu_torch/csrc/*.cu (cached in
     ntsynt_tpu_torch/_build/ by source hash); host_build: g++ builds
     the host library (csrc/host/*.cpp: the OpenMP FASTA packer and the
     chain walker) there too, and the OpenMP runtime it runs on is named;
  3. kernels: each CUDA kernel against its plain PyTorch version on the
     same inputs (made from a seed), at the shapes the main path gives
     it and at the edges of K1's, K2's, K3's and K4's designs; outputs
     must be bit-identical (max_abs_err 0). Every kernel reports its
     device time (ms: launches captured in a CUDA graph, its replay
     timed; K3's launches without the wrapper's host sync) apart from
     its wrapper's (wrapper_ms: a timed loop of calls); K1 and K4 also
     the repeat walk's shape, K4 a 2^34-bit filter and its bin/apply
     split, K5 its cascade, its two single-cell rows, its bin/apply split
     and its edge cases (k5_edges); K2 also the one PyTorch expression
     that computes it (library_ms, k2_library), at w=1000 and w=10,000,
     and K3 its boolean-mask indexing (k3_library) at each of its rows;
     K3 reads the legit mask as bits, also at odd bit offsets; the
     unpack of the packed upload (csrc/unpack.cu) at the main path's
     group of 2^26 codes, at the JAX package's 2^26 + 24 and at the
     edges of its two routes;
  4. main path: two 100 Mbp genomes (0.1% SNPs, one 50 kb inversion) are
     generated into a temporary directory and run through the port's CLI
     (``python -m ntsynt_tpu_torch a.fa b.fa -d 1``) on the card; the
     blocks TSV must hold the inversion as a '-' block and every kernel
     of the path must have launched; prints each launch's sizes and the
     run's peak device memory; the FASTA reads and the chain walk run
     natively (the host library);
  5. winmin_refine: the window-argmin kernel against its plain version at
     the key counts the main path's refinement rounds gave it, and the
     compaction kernel on its output there, each with its device time and
     its wrapper's time;
  6. sweep path: the 2 x 100 Mbp cascade built through the binned sweep
     (NTSYNT_BF_SWEEP=1) must equal the atomic-OR cascade word for word,
     and the CLI run with the sweep on must write the main path's blocks,
     launching the sweep and never the atomic-OR insert;
  7. filter paths: the CLI with --filter Indexlr and with --filter Filter
     (the repeat filter) on the same genomes, each finding the inversion;
  8. make_bf: make-common-bf --format btllib, reloaded through load_bf,
     gives the cascade's words;
  9. card vs CPU: a 200 kb two-genome scenario through the CLI on
     --device cuda and --device cpu, without and with each --filter
     mode; every artifact must be byte-identical;
 10. host_native: genome A, and a copy split into 12 contigs, read
     natively at one thread and at os.cpu_count() threads and by NumPy
     (native=False); every field and the .fai must be identical; each
     read's seconds;
 11. walk: the main path's CLI run again with NTSYNT_NO_NATIVE_WALK=1
     must write the same blocks TSV; both runs' synteny and read
     seconds, and the walk alone (native and NumPy) on chains of the
     main path's and of a gigabase genome's size;
 12. sidecars: stats, sort_blocks, the gggenomes files and the
     chromosome painting on the main path's blocks TSV and .fai files,
     with their seconds, and the plots where matplotlib is installed;
 13. mesh: the multi-process path (``python -m
     ntsynt_tpu_torch.parallel.multihost``, one process per rank, each in
     its own directory with its own timeout) on the 2 x 100 Mbp pair: one
     rank under NCCL must write the main path's blocks; two ranks sharing
     the card under NCCL (what NCCL says is printed; expected to be
     refused, and a hang or any other failure fails), then under gloo on
     the default path and with --filter Indexlr, must write the
     single-device runs' blocks from rank 0 and nothing from rank 1
     (for --filter Indexlr, the single-device CLI reusing a repeat filter
     walked at the mesh's 2^21-k-mer segment), every rank launching K1-K4
     on the card; the default gloo run again
     in the same directories, where rank 0 reuses its sketch TSVs; two
     ranks (``chip_smoke.py --mesh-worker``) build the common filter,
     which must equal the single-device cascade's words, and time
     allreduce_or and _allreduce_dup on a 2^32-bit filter;
 14. gigabase: bench.py's three 1 Gbp genomes (seed 20260817, 0.1% SNPs
     in each copy, a 500 kb inversion at 0.4 L in genome B) written once
     as FASTA (the disk's free bytes recorded first): (a) the default
     CLI in a process of its own (``chip_smoke.py --cli-worker``) must
     find the inversion, name all three genomes in its blocks and launch
     K1-K4 as often as 3 Gbp in 2^26-k-mer segments gives, and prints
     its stage seconds, host RSS, device peaks and the packed bytes it
     sent; (b) the same run in
     this process with the cascade's stream budget patched below the
     projection, so that every stream is released and built again at its
     sketch, must write run a's blocks byte for byte; (c) a genome of
     two 1.1 Gbp contigs and a 4 Mbp tail past stream offset 2^31,
     sketched on the card after the cascade over it and a copy with
     0.1% SNPs, must give on the tail exactly the CPU port's sketch of
     the tail alone (the genome's upload alone is timed first: seconds,
     bytes sent and held); (d) the mesh at D = 1 must give the card's
     sketch of that genome;
 15. published_shapes: the JAX package's other two published shapes,
     bench.py's genomes (seed 20260817) through the default CLI, each in
     a process of its own: (a) 2 x 3 Gbp (one 3 Gbp contig a genome, a
     1.5 Mbp inversion at 1.2 Gbp in genome B): MemTotal and free disk
     recorded first (too little of either fails); 3 blocks of 2 rows,
     the inversion found within 150 kb, each genome's last block ending
     past 2^31, the common filter at the 2^34-bit cap, each cascade
     level's occupancy printed beside the JAX package's, K1-K4 launched
     as 45 segments a genome give, and the CLI's minimizers in a 4 Mbp
     slice of genome A past 2^31 equal to the CPU port's sketch of the
     slice probed against a CPU copy of the same filter (built in this
     process; genome A's upload alone is timed: seconds, bytes sent and
     held), the CLI's device peak below the 18.581 GB of the unpacked
     upload, and the packed bytes it sent; (b) 11 x 100 Mbp: 3 blocks of
     one row a genome and one minimizer count each, the 50 kb inversion
     found, 11 cascade levels on a 2^32-bit filter, the launches the
     segments give, the packed bytes sent; (c) the
     11-genome shape at 11 x 1 Mbp on --device cuda and --device cpu:
     every artifact byte-identical.
Each path's kernel counts are set to 0 just before it and read just
after (a mesh rank's, which start at 0 in its own process, at its end). Then the kernel table as one JSON line, nvidia-smi's "name, power
limit" line, and last {"ok": true, "device": {...}}. Any failed check
raises, so the script exits non-zero; without CUDA, or without the
package beside it, it exits non-zero before printing any result.
"""

import contextlib
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

SEED = 20261017
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
GENOME_BP = 100_000_000
INV_BP = 50_000
FILTER_LOG2 = 32  # the common filter's size at 100 Mbp (--fpr 0.025)
# the kernels each path launches (bf_insert builds the repeat filter on
# the --filter paths; the sweep path's cascade never runs it)
PATH_KERNELS = {
    "main": ("nthash", "winmin", "compact", "bf_insert", "unpack"),
    "sweep": ("nthash", "winmin", "compact", "bf_sweep", "unpack"),
    "sweep_build": ("nthash", "bf_sweep", "unpack"),
    "filter": ("nthash", "winmin", "compact", "bf_insert", "unpack"),
    "sketch": ("nthash", "winmin", "compact", "unpack"),  # a sketch alone (the gigabase mesh check)
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


@contextlib.contextmanager
def phase(name: str, info: dict):
    t0 = time.perf_counter()
    yield info
    emit({"phase": name, "seconds": round(time.perf_counter() - t0, 3), **info})


def cuda_time_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of fn on the card (CUDA events around a
    Python loop of calls, after one warm-up call): device time where the
    card is busy, the wrapper's host time where it waits between calls."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fns, reps: int = 10) -> float:
    """Mean device milliseconds per call: reps calls (cycling through fns,
    a callable or a list of them) captured in one CUDA graph, whose replay
    is timed with CUDA events after a warm-up replay. The host's time in
    the wrappers between launches is not counted, as it is by
    cuda_time_ms."""
    import torch

    fns = fns if isinstance(fns, (list, tuple)) else [fns]
    fns[0]()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for i in range(reps):
            fns[i % len(fns)]()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / reps
    del graph
    torch.cuda.empty_cache()
    return ms


def max_abs_err(a, b) -> float:
    """0.0 when the tensors are equal, else the largest |a - b|."""
    if a.shape != b.shape:
        raise AssertionError(f"shape mismatch {tuple(a.shape)} vs {tuple(b.shape)}")
    if bool((a == b).all()):
        return 0.0
    return float((a.double() - b.double()).abs().max())


def require_equal(name: str, pairs) -> float:
    err = 0.0
    for a, b in pairs:
        err = max(err, max_abs_err(a, b))
    if err != 0.0:
        raise AssertionError(f"{name}: kernel differs from its plain version (max_abs_err {err})")
    return err


# ---------------------------------------------------------------------------
# genomes
# ---------------------------------------------------------------------------

_DEC = np.frombuffer(b"ACGT", dtype=np.uint8)


def write_fasta(path: str, contigs, width: int = 80) -> str:
    with open(path, "wb") as fout:
        for name, codes in contigs:
            fout.write(f">{name}\n".encode())
            raw = _DEC[codes]
            full = len(raw) // width * width
            body = np.full((full // width, width + 1), ord("\n"), dtype=np.uint8)
            body[:, :width] = raw[:full].reshape(-1, width)
            fout.write(body.tobytes())
            if full < len(raw):
                fout.write(raw[full:].tobytes() + b"\n")
    return path


def make_pair(tmp: str, length: int, inv_start: int, inv_len: int, snp_rate: float, seed: int):
    """Genome A and a copy with point substitutions and one inversion."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 4, length, dtype=np.uint8)
    mut = base.copy()
    n_snp = int(rng.binomial(length, snp_rate))
    pos = rng.integers(0, length, n_snp)
    mut[pos] = (mut[pos] + rng.integers(1, 4, n_snp, dtype=np.uint8)) % 4
    e = inv_start + inv_len
    mut[inv_start:e] = mut[inv_start:e][::-1] ^ 3
    fa = write_fasta(os.path.join(tmp, "genomeA.fa"), [("chr1", base)])
    fb = write_fasta(os.path.join(tmp, "genomeB.fa"), [("chr1", mut)])
    return fa, fb


def read_blocks(path: str):
    rows = []
    with open(path) as fin:
        for line in fin:
            p = line.rstrip("\n").split("\t")
            rows.append(dict(id=int(p[0]), asm=p[1], ctg=p[2], start=int(p[3]),
                             end=int(p[4]), ori=p[5], nmx=int(p[6])))
    return rows


def run_cli(workdir: str, args) -> str:
    """The port's CLI in this process, from workdir (it writes its
    artifacts to the working directory). Returns the blocks TSV path."""
    from ntsynt_tpu_torch.cli import main

    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        rc = main(args)
    finally:
        os.chdir(cwd)
    if rc != 0:
        raise AssertionError(f"CLI returned {rc}")
    return os.path.join(workdir, "smoke.synteny_blocks.tsv")


@contextlib.contextmanager
def env_set(name: str, value):
    """Environment variable name set to value (None: unset) inside the
    block."""
    old = os.environ.get(name)
    if value is None:
        os.environ.pop(name, None)
    else:
        os.environ[name] = value
    try:
        yield
    finally:
        if old is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = old


def drive_path(torch, name: str, fn):
    """Run fn with every kernel count set to 0 just before and read just
    after; every kernel of the path must have launched. Returns (fn's
    result, launches, launch sizes)."""
    from ntsynt_tpu_torch.ops import _kernels

    _kernels.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    launches = dict(_kernels.LAUNCHES)
    shapes = {k: list(v) for k, v in _kernels.SHAPES.items()}
    for kernel in PATH_KERNELS[name]:
        if launches[kernel] <= 0:
            raise AssertionError(f"kernel {kernel} was not launched on the {name} path")
    return out, launches, shapes


def read_stages(path: str) -> dict:
    stages = {}
    with open(path) as fin:
        next(fin)
        for line in fin:
            p = line.rstrip("\n").split("\t")
            stages[p[0]] = {"s": float(p[1]), "peak_rss_mb": float(p[2]),
                            "cuda_peak_so_far_mb": float(p[3])}
    return stages


def find_inversion(rows, inv_start: int, inv_end: int, tol: int = 5000) -> dict:
    """The first '-' block whose ends lie within tol of the inversion's
    (5 kb for the 50 kb inversion)."""
    hit = [r for r in rows if r["ori"] == "-" and abs(r["start"] - inv_start) < tol
           and abs(r["end"] - inv_end) < tol]
    if not hit:
        raise AssertionError(f"no '-' block covers the inversion [{inv_start}, {inv_end}): {rows}")
    return {k: hit[0][k] for k in ("asm", "start", "end", "ori", "nmx")}


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def k2_library(torch, keys, w: int):
    """K2's function as one PyTorch reduction (the yardstick, used nowhere
    in the port): the minimum of each window of the sign-flipped keys,
    torch.min giving the first minimal index. Returns (arg, minv)."""
    sign = -(1 << 63)  # maps uint64 order onto int64 order
    minv, rel = (keys ^ sign).unfold(0, w, 1).min(dim=1)
    return rel + torch.arange(rel.shape[0], device=keys.device), minv ^ sign


def time_winmin(winmin, keys, w: int, reps: int = 10) -> dict:
    """K2 vs its plain version on keys at window w: check, then time its
    device time (ms, a CUDA graph of launches) and its wrapper's time
    (wrapper_ms, a loop of calls); and the library expression
    (k2_library) on the same keys, which must equal the plain version
    bit for bit."""
    import torch

    from ntsynt_tpu_torch.ops import _kernels

    arg, minv = winmin.window_argmin(keys, w)
    parg, pminv = winmin.window_argmin_plain(keys, w)
    err = require_equal(f"K2 w={w}", [(arg, parg), (minv, pminv)])
    del arg, minv, parg, pminv
    m = keys.shape[0]
    larg, lminv = k2_library(torch, keys, w)
    parg, pminv = winmin.window_argmin_plain(keys, w)
    if not (torch.equal(larg, parg) and torch.equal(lminv, pminv)):
        raise AssertionError(f"k2_library differs from window_argmin_plain at w={w}")
    del larg, lminv, parg, pminv
    return dict(
        max_abs_err=err,
        ms=device_ms(lambda: winmin.window_argmin(keys, w), reps),
        wrapper_ms=cuda_time_ms(lambda: winmin.window_argmin(keys, w), reps),
        plain_ms=cuda_time_ms(lambda: winmin.window_argmin_plain(keys, w), 1),
        library_ms=cuda_time_ms(lambda: k2_library(torch, keys, w), 1),
        bound_ms=(8 * m + 16 * (m - w + 1)) / HBM_BYTES_PER_S * 1e3,
        plan=list(winmin.winmin_plan(m, w, _kernels.sm_count(keys.device.index))),
        shape=f"{m} keys, w={w}",
    )


# the edges of K2's and K4's designs, as in tests/test_torch_redesign.py
K2_EDGE_WS = (1, 10, 37, 100, 250, 1000, 4095, 10_000)
K4_EDGE_BITS = (16, 20, 32, 33, 34, 35, 36)


def k2_edges(torch, dev, winmin, rng) -> int:
    """K2 vs its plain version at every edge w: n = w, w + 1, not a
    multiple of G*w, and 2^20 + 3; random and tie-heavy keys (few
    distinct values, so runs of equal minima); an unaligned view."""
    cases = 0
    for w in K2_EDGE_WS:
        g = max((winmin.TILE_KEYS - 2) // w - 1, 1)  # w-blocks in a full tile
        for n in (w, w + 1, 3 * g * w + 17, (1 << 20) + 3):
            rand = rng.integers(-(1 << 63), (1 << 63) - 1, n, dtype=np.int64)
            ties = (rng.integers(0, 5, n, dtype=np.int64) << 60).astype(np.int64)
            ties[rng.random(n) < 0.3] = -1
            for label, keys_np in (("random", rand), ("ties", ties)):
                keys = torch.from_numpy(keys_np).to(dev)
                require_equal(f"K2 {label} w={w} n={n}", zip(winmin.window_argmin(keys, w),
                                                             winmin.window_argmin_plain(keys, w)))
                cases += 1
        keys = torch.from_numpy(ties).to(dev)[1:]  # not 16-byte aligned
        require_equal(f"K2 unaligned w={w}", zip(winmin.window_argmin(keys, w),
                                                 winmin.window_argmin_plain(keys, w)))
        cases += 1
    return cases


def k4_edges(torch, bloom, canon, valid) -> int:
    """K4's direct route, binned route and insert_words vs the plain
    version: at every edge filter size on 2^22 + 3 keys (not a multiple
    of a tile), and n = 1, all keys invalid, every key in one cell, and
    the repeat walk's 2^20 keys into 2^33 bits."""
    m = (1 << 22) + 3
    cases = [(bits, canon[:m], valid[:m]) for bits in K4_EDGE_BITS]
    cases += [(32, canon[:1], valid[:1]),
              (32, canon[:100_001], torch.zeros_like(valid[:100_001])),
              (32, canon[: 1 << 22] & ((1 << 20) - 1) | (5 << 20), valid[: 1 << 22]),
              (33, canon[: 1 << 20], valid[: 1 << 20])]
    for bits, c, v in cases:
        ref = bloom.insert_words_plain(
            torch.zeros((1 << bits) // 32, dtype=torch.int32, device=c.device), c, v, bits)
        for insert in (bloom.insert_direct, bloom.insert_binned, bloom.insert_words):
            words = torch.zeros_like(ref)
            insert(words, c, v, bits)
            require_equal(f"K4 {insert.__name__} 2^{bits} bits, {c.shape[0]} keys",
                          [(words, ref)])
            del words
        del ref
        torch.cuda.empty_cache()
    return len(cases)


# the edges of K1's and K3's designs, as in tests/test_torch_redesign2.py
K1_EDGE_KS = (1, 2, 19, 24, 31, 32, 33, 64, 129)


def k1_codes(rng, n: int, k: int):
    """Random codes with N runs (one longer than k), single Ns and codes
    5-255, which count as N."""
    codes = rng.integers(0, 4, n).astype(np.uint8)
    codes[rng.random(n) < 0.01] = 4
    junk = rng.random(n) < 0.005
    codes[junk] = rng.integers(5, 256, int(junk.sum()))
    codes[n // 3 : n // 3 + k + 7] = 4
    return codes


def k1_edges(torch, nthash, rng) -> int:
    """K1 vs its plain version at every edge k: n = 1, n not a multiple
    of a run or a tile, an N on a tile's first and last code and inside
    its halo, every code N, a codes view at an odd offset, and k past the
    staged halo (codes read from device memory)."""
    from ntsynt_tpu_torch.ops import _kernels

    sms = _kernels.sm_count(0)
    cases = 0

    def check(codes, k, n, label):
        nonlocal cases
        require_equal(f"K1 {label} k={k} n={n}",
                      zip(nthash.hash_kmers(codes, k, n), nthash.hash_kmers_plain(codes, k, n)))
        cases += 1

    for k in K1_EDGE_KS:
        for n in (1, 1000, (1 << 20) + 3, (1 << 22) + 5):
            tile = nthash.THREADS * nthash.nthash_plan(n, k, sms)[0]
            codes = k1_codes(rng, n + k - 1, k)
            for p in (0, tile - 1, tile, tile + k // 2, 2 * tile + k - 1, n + k - 2):
                if p < len(codes):
                    codes[p] = 4
            check(torch.from_numpy(codes).cuda(), k, n, "random")
        check(torch.full((5000 + k,), 4, dtype=torch.uint8, device="cuda"), k, 5001, "all N")
        view = torch.from_numpy(k1_codes(rng, 70_002 + k, k)).cuda()[3:]
        check(view, k, 70_000, "odd offset")
    for k in (nthash.MAX_STAGED_K, nthash.MAX_STAGED_K + 1, 10_000):
        check(torch.from_numpy(k1_codes(rng, 40_000 + k - 1, k)).cuda(), k, 40_000, "long k")
    return cases


def k3_cases(rng, tile: int):
    """(label, arg, minv, legit) at the edges of K3's design."""
    cases = []
    for nw in (1, 2, tile - 1, tile, tile + 1, 3 * tile + 17):
        arg = np.maximum.accumulate(rng.integers(0, nw + 50, nw)).astype(np.int64)
        minv = rng.integers(-(1 << 62), 1 << 62, nw)
        minv[rng.random(nw) < 0.1] = -1
        cases.append((f"random nw={nw}", arg, minv, rng.random(nw) < 0.95))
    nw = 3 * tile + 5
    arg = np.arange(nw, dtype=np.int64)
    minv = rng.integers(0, 1 << 62, nw)
    cases.append(("every window flagged", arg, minv, np.ones(nw, bool)))
    cases.append(("no valid window", arg, np.full(nw, -1, np.int64), np.ones(nw, bool)))
    cases.append(("no legit window", arg, minv, np.zeros(nw, bool)))
    runs = np.repeat(np.arange(nw // 64 + 1, dtype=np.int64) * 64, 64)[:nw]
    runs[tile:] += 1  # a run change exactly at the second tile's first window
    runs[2 * tile - 3 :] += 1
    cases.append(("run change at a tile's first window", runs, minv, np.ones(nw, bool)))
    legit = np.ones(nw, bool)
    legit[tile - 40 : tile + 40] = False  # a contig gap across a tile boundary
    legit[2 * tile - 1] = False  # the last window before a tile is not live
    cases.append(("legit gaps across tiles", runs, minv, legit))
    nw = 1 << 24  # more tiles than the card holds blocks at once
    arg = np.maximum.accumulate(rng.integers(0, nw, nw)).astype(np.int64)
    cases.append(("2^24 windows", arg, rng.integers(-(1 << 62), 1 << 62, nw),
                  rng.random(nw) < 0.99))
    return cases


def legit_bits(torch, mask: np.ndarray, offset: int = 0):
    """A bool window mask as K3's legit input on the card: little-endian
    bits, the mask's first window at bit offset (the bits before it set,
    as another share's windows would be)."""
    return torch.from_numpy(np.packbits(np.concatenate([np.ones(offset, bool), mask]),
                                        bitorder="little")).cuda()


def k3_edges(torch, sketch_device, rng) -> int:
    """K3 vs its plain version on every case of k3_cases, into new
    buffers, in place (as sketch_stream compacts) and with the mask at
    odd bit offsets (as a mesh share or a segment reads it)."""
    cases = k3_cases(rng, sketch_device.COMPACT_TILE)
    for label, arg, minv, legit in cases:
        a, m = torch.from_numpy(arg).cuda(), torch.from_numpy(minv).cuda()
        lg = legit_bits(torch, legit)
        ref = sketch_device.compact_plain(a, m, lg)
        require_equal(f"K3 {label}", zip(sketch_device.compact_minimizers(a, m, lg), ref))
        for off in (3, 13):
            require_equal(f"K3 {label}, bit offset {off}", zip(sketch_device.compact_minimizers(
                a, m, legit_bits(torch, legit, off), off), ref))
        require_equal(f"K3 {label}, in place",
                      zip(sketch_device.compact_minimizers(a, m, lg, out=(a, m)), ref))
    return 4 * len(cases)


def unpack_codes(rng, n: int) -> np.ndarray:
    """n random codes with N runs and single Ns."""
    codes = rng.integers(0, 4, n).astype(np.uint8)
    codes[rng.random(n) < 0.001] = 4
    codes[n // 3 : n // 3 + 100] = 4
    return codes


def packed_on_card(torch, fio, codes: np.ndarray):
    """codes (len % 8 == 0) packed by the host library, as one contig
    filling the stream, on the card: (packed2, nbits)."""
    n = len(codes)
    p2, nb = fio.pack_stream(codes, np.zeros(1, np.int64), np.array([n]), np.zeros(1, np.int64),
                             n)
    return torch.from_numpy(p2).cuda(), torch.from_numpy(nb).cuda()


def unpack_edges(torch, unpack, fio, rng) -> int:
    """The unpack kernel vs its plain version and the codes it was packed
    from, on both of its routes: n a multiple of 128 (16-byte route) or
    not (byte route), the smallest n, all N, and out a view of a larger
    buffer at an offset that keeps or breaks 16-byte alignment (the
    neighbours must stay untouched)."""
    cases = 0
    for n in (8, 128, 136, 8 * 1021, (1 << 20) + 8, (1 << 20) + 128):
        codes = unpack_codes(rng, n)
        if n == 136:
            codes[:] = 4
        p2, nb = packed_on_card(torch, fio, codes)
        want = torch.from_numpy(codes).cuda()
        for off in (0, 8, 16):
            big = torch.full((n + 64,), 9, dtype=torch.uint8, device="cuda")
            unpack.unpack(p2, nb, out=big[off:off + n])
            require_equal(f"unpack n={n} at offset {off}",
                          [(big[off:off + n], unpack.unpack_plain(p2, nb)),
                           (big[off:off + n], want)])
            if bool((big[:off] != 9).any()) or bool((big[off + n:] != 9).any()):
                raise AssertionError(f"unpack n={n} at offset {off} wrote past its view")
            cases += 1
    return cases


def time_unpack(torch, unpack, fio, rng, n: int, reps: int = 20) -> dict:
    """The unpack of n codes (one group as the upload sends it) vs its
    plain version and the codes it was packed from, then its device time
    (a CUDA graph of launches), its wrapper's and the plain version's."""
    codes = unpack_codes(rng, n)
    p2, nb = packed_on_card(torch, fio, codes)
    out = unpack.unpack(p2, nb)
    err = require_equal(f"unpack {n} codes", [(out, unpack.unpack_plain(p2, nb)),
                                               (out, torch.from_numpy(codes).cuda())])
    m = n // 8
    return dict(
        max_abs_err=err,
        ms=device_ms(lambda: unpack.unpack(p2, nb, out), reps),
        wrapper_ms=cuda_time_ms(lambda: unpack.unpack(p2, nb, out), reps),
        plain_ms=cuda_time_ms(lambda: unpack.unpack_plain(p2, nb), 2),
        bound_ms=(3 * n // 8 + n) / HBM_BYTES_PER_S * 1e3,
        shape=f"{n} codes ({'16-byte' if m % 16 == 0 else 'byte'} route)",
    )


def phase_kernels(torch, dev, kernels: dict) -> None:
    """Each kernel vs its plain version at main-path shapes."""
    from ntsynt_tpu_torch.io import fasta as fio
    from ntsynt_tpu_torch.ops import (_kernels, bf_build, bf_sweep, bloom, nthash,
                                      sketch_device, unpack, winmin)

    rng = np.random.default_rng(SEED)
    k = 24
    n = bf_build.SEG_KMERS  # the main path's segment: 2^26 k-mers / windows
    codes_np = rng.integers(0, 4, n + k - 1, dtype=np.uint8)
    codes_np[rng.random(n + k - 1) < 0.001] = 4  # N runs of one base
    codes = torch.from_numpy(codes_np).to(dev)

    # K1: device time (a CUDA graph of launches) apart from the wrapper's
    key, canon, valid = nthash.hash_kmers(codes, k, n)
    pk, pc, pv = nthash.hash_kmers_plain(codes, k, n)
    err = require_equal("K1", [(key, pk), (canon, pc), (valid, pv)])
    del pk, pc, pv
    # the repeat walk's shape: 2^20 k-mers, a new segment in each call
    m = 1 << 20
    segs = [codes[i * m:(i + 1) * m + k - 1] for i in range(10)]
    err_walk = require_equal("K1 2^20", zip(nthash.hash_kmers(segs[0], k, m),
                                            nthash.hash_kmers_plain(segs[0], k, m)))
    repeat_walk = dict(
        max_abs_err=err_walk,
        ms=device_ms([lambda c=c: nthash.hash_kmers(c, k, m) for c in segs], 20),
        wrapper_ms=cuda_time_ms(lambda: nthash.hash_kmers(segs[0], k, m), 20),
        plain_ms=cuda_time_ms(lambda: nthash.hash_kmers_plain(segs[0], k, m), 2),
        bound_ms=(m + k - 1 + 17 * m) / HBM_BYTES_PER_S * 1e3,
        shape=f"{m} k-mers, k={k}",
        run=nthash.nthash_plan(m, k, _kernels.sm_count(dev.index))[0],
    )
    kernels["nthash"].update(
        max_abs_err=max(err, err_walk),
        ms=device_ms(lambda: nthash.hash_kmers(codes, k, n)),
        wrapper_ms=cuda_time_ms(lambda: nthash.hash_kmers(codes, k, n), 10),
        plain_ms=cuda_time_ms(lambda: nthash.hash_kmers_plain(codes, k, n), 2),
        bound_ms=(n + k - 1 + 17 * n) / HBM_BYTES_PER_S * 1e3,
        shape=f"{n} k-mers, k={k}",
        run=nthash.nthash_plan(n, k, _kernels.sm_count(dev.index))[0],
        repeat_walk=repeat_walk,
        edge_cases=k1_edges(torch, nthash, rng),
    )
    del segs

    # the unpack at the main path's group (2^26 codes; the stream's last
    # group and mesh slabs take the byte route) and at the JAX package's
    # group length (2^26 + k - 1 codes, rounded up to 8)
    kernels["unpack"].update(time_unpack(torch, unpack, fio, rng, n),
                             jax_group=time_unpack(torch, unpack, fio, rng, n + 24),
                             edge_cases=unpack_edges(torch, unpack, fio, rng))

    # K2 at the main path's w (and a streamed w past the staging limit);
    # the refinement rounds' shapes are timed after the main path has
    # recorded them (phase_winmin_refine)
    k2 = time_winmin(winmin, key, 1000)
    k2_stream = time_winmin(winmin, key, 10_000, reps=5)
    arg_main, minv_main = winmin.window_argmin(key, 1000)
    k2["edge_cases"] = k2_edges(torch, dev, winmin, rng)
    kernels["winmin"].update(k2, by_w={"1000": k2, "10000": k2_stream})

    # K3 on K2's output, with contig gaps in the legit mask
    nw = arg_main.shape[0]
    legit_np = np.ones(nw, dtype=bool)
    for s in rng.integers(0, nw - 2000, 64):
        legit_np[s : s + 1000 + k] = False
    legit = legit_bits(torch, legit_np)
    pos = sketch_device.compact_minimizers(arg_main, minv_main, legit)[0]
    if pos.shape[0] == 0 or bool((pos[1:] <= pos[:-1]).any()):
        raise AssertionError("K3: selections must be non-empty and strictly increasing")
    del pos
    kernels["compact"].update(
        time_compact(torch, sketch_device, arg_main, minv_main, legit),
        edge_cases=k3_edges(torch, sketch_device, rng),
    )
    del arg_main, minv_main, legit
    torch.cuda.empty_cache()

    # K4 into a 2^32-bit filter, the main path's size at 100 Mbp
    bits = FILTER_LOG2
    nwords = (1 << bits) // 32
    words = torch.zeros(nwords, dtype=torch.int32, device=dev)
    bloom.insert_words(words, canon, valid, bits)
    pwords = bloom.insert_words_plain(torch.zeros_like(words), canon, valid, bits)
    err = require_equal("K4", [(words, pwords)])
    del pwords
    # every route at the edges of the design, filters up to 2^36 bits
    # (canon's high bits index their words) among them
    k4_cases = k4_edges(torch, bloom, canon, valid)
    # only the words that valid keys hit must be read and written
    hit_words = torch.unique(bloom.bit_index(canon[valid], bits)[0]).numel()
    k4_bound = (9 * n + 8 * hit_words) / HBM_BYTES_PER_S * 1e3
    # where the binned route's time goes: steps 1-2 (count, scan, the
    # partition passes) and step 3 (the per-cell apply), each timed
    # alone; and the direct route (one global atomicOr per key, the
    # kernel's former design) beside it
    binned, offsets, _ = bloom.bin_keys(canon, valid, bits)
    stage_ms = dict(
        bin=device_ms(lambda: bloom.bin_keys(canon, valid, bits)),
        apply=device_ms(lambda: bloom.apply_bins(words, binned, offsets, bits)),
    )
    del binned, offsets
    direct_ms = device_ms(lambda: bloom.insert_direct(words, canon, valid, bits))
    # the repeat walk's shape: 2^20 keys into 2^33 bits, a new segment's
    # keys in each call (the walk finds the filter cold)
    rbits, m = 33, 1 << 20
    rwords = torch.zeros((1 << rbits) // 32, dtype=torch.int32, device=dev)
    segs = [(canon[i * m:(i + 1) * m], valid[i * m:(i + 1) * m]) for i in range(10)]
    r_hits = torch.unique(bloom.bit_index(segs[0][0][segs[0][1]], rbits)[0]).numel()
    repeat_walk = dict(
        route=bloom.insert_route(m, rbits),
        ms=device_ms([lambda c=c, v=v: bloom.insert_words(rwords, c, v, rbits) for c, v in segs]),
        wrapper_ms=cuda_time_ms(lambda: bloom.insert_words(rwords, *segs[0], rbits), 10),
        direct_ms=device_ms([lambda c=c, v=v: bloom.insert_direct(rwords, c, v, rbits)
                             for c, v in segs]),
        binned_ms=device_ms([lambda c=c, v=v: bloom.insert_binned(rwords, c, v, rbits)
                             for c, v in segs]),
        plain_ms=cuda_time_ms(lambda: bloom.insert_words_plain(rwords, *segs[0], rbits), 2),
        bound_ms=(9 * m + 8 * r_hits) / HBM_BYTES_PER_S * 1e3,
        shape=f"{m} keys into 2^{rbits} bits ({r_hits} distinct words hit)",
    )
    del rwords, segs
    # the 3 x 1 Gbp common filter's size: 2^26 keys into 2^34 bits, both
    # routes (the wrapper bins: half a key per 8 words)
    gbits = 34
    gwords = torch.zeros((1 << gbits) // 32, dtype=torch.int32, device=dev)
    g_hits = torch.unique(bloom.bit_index(canon[valid], gbits)[0]).numel()
    gigabase_filter = dict(
        route=bloom.insert_route(n, gbits),
        ms=device_ms(lambda: bloom.insert_words(gwords, canon, valid, gbits), 5),
        wrapper_ms=cuda_time_ms(lambda: bloom.insert_words(gwords, canon, valid, gbits), 5),
        plain_ms=cuda_time_ms(lambda: bloom.insert_words_plain(gwords, canon, valid, gbits), 2),
        direct_ms=device_ms(lambda: bloom.insert_direct(gwords, canon, valid, gbits), 5),
        bound_ms=(9 * n + 8 * g_hits) / HBM_BYTES_PER_S * 1e3,
        shape=f"{n} keys into 2^{gbits} bits ({g_hits} distinct words hit)",
    )
    del gwords
    torch.cuda.empty_cache()
    kernels["bf_insert"].update(
        max_abs_err=err,
        ms=device_ms(lambda: bloom.insert_words(words, canon, valid, bits)),
        wrapper_ms=cuda_time_ms(lambda: bloom.insert_words(words, canon, valid, bits), 10),
        plain_ms=cuda_time_ms(lambda: bloom.insert_words_plain(words, canon, valid, bits), 2),
        bound_ms=k4_bound,
        shape=f"{n} keys into 2^{bits} bits ({hit_words} distinct words hit)",
        insert_route=bloom.insert_route(n, bits),
        stage_ms=stage_ms,
        direct_ms_same_shape=direct_ms,
        repeat_walk=repeat_walk,
        gigabase_filter=gigabase_filter,
        edge_cases=k4_cases,
    )

    # K5 against its plain version at the edges of its design and at its
    # four timed rows, then timed (phase_k5)
    kernels["bf_sweep"].update(phase_k5(torch, dev, canon, valid, bits, words, hit_words,
                                        k4_bound, kernels["bf_insert"]["ms"]))
    del words, key, canon, valid, codes
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    _kernels.reset_launches()


def k5_check(torch, bf_sweep, label: str, c, v, bits: int, prev=None) -> float:
    """K5 (insert, or cascade over prev) into zeroed words against its
    plain version on the same inputs."""
    words = torch.zeros((1 << bits) // 32, dtype=torch.int32, device=c.device)
    if prev is None:
        bf_sweep.insert_segment(words, c, v, bits)
    else:
        bf_sweep.cascade_segment(prev, words, c, v, bits)
    ref = bf_sweep.sweep_plain(torch.zeros_like(words), c, v, bits, prev=prev)
    return require_equal(f"K5 {label}", [(words, ref)])


def k5_edges(torch, bf_sweep, canon, valid) -> int:
    """K5 vs its plain version, insert and cascade (over a prev holding
    every other key, over an empty prev and over a full one): n = 1, a
    partition tile +- 1, no valid key, every key in one cell of a 2^16-bit
    filter, in one 2^19-bit cell and in one 2^24-bit cell of a 2^32-bit
    filter, views of canon and valid at an odd offset, and 2^22 + 3 keys
    at every geometry from 2^16 to 2^32 bits."""
    m = 1 << 22
    cases = [("n=1", 32, canon[:1], valid[:1]),
             ("tile-1", 32, canon[:4095], valid[:4095]),
             ("tile+1", 32, canon[:4097], valid[:4097]),
             ("no valid key", 32, canon[:100_001], torch.zeros_like(valid[:100_001])),
             ("one cell of 2^16", 16, canon[:m], valid[:m]),
             ("one 2^19-bit cell", 32, canon[:m] & ((1 << 19) - 1), valid[:m]),
             ("one 2^24-bit cell", 32, canon[:m] & ((1 << 24) - 1) | (7 << 24), valid[:m]),
             ("odd-offset view", 32, canon[1 : (1 << 20) + 1], valid[1 : (1 << 20) + 1])]
    cases += [(f"2^{b} bits", b, canon[: m + 3], valid[: m + 3])
              for b in (16, 20, 21, 24, 25, 28, 29, 31, 32)]
    for label, bits, c, v in cases:
        label = f"{label}, {c.shape[0]} keys into 2^{bits} bits"
        k5_check(torch, bf_sweep, f"insert {label}", c, v, bits)
        n_words = (1 << bits) // 32
        half = bf_sweep.sweep_plain(torch.zeros(n_words, dtype=torch.int32, device=c.device),
                                    c[::2], v[::2], bits)
        k5_check(torch, bf_sweep, f"cascade {label}", c, v, bits, prev=half)
        k5_check(torch, bf_sweep, f"cascade, empty prev, {label}", c, v, bits,
                 prev=torch.zeros_like(half))
        k5_check(torch, bf_sweep, f"cascade, full prev, {label}", c, v, bits,
                 prev=torch.full_like(half, -1))
        del half
    torch.cuda.empty_cache()
    return 4 * len(cases)


def phase_k5(torch, dev, canon, valid, bits: int, k4_words, hit_words: int, k4_bound: float,
             k4_ms: float) -> dict:
    """K5 against its plain version and K4's words, at its edges and its
    four timed rows (insert and cascade of the main path's segment into
    the 100 Mbp filter's size; 2^22 keys into a 2^16-bit filter and into
    one 2^19-bit cell of a 2^32-bit one), then its device times."""
    from ntsynt_tpu_torch.ops import bf_sweep, bloom

    n = canon.shape[0]
    swept = torch.zeros_like(k4_words)
    bf_sweep.insert_segment(swept, canon, valid, bits)
    pswept = bf_sweep.sweep_plain(torch.zeros_like(swept), canon, valid, bits)
    err = require_equal("K5 insert", [(swept, pswept), (swept, k4_words)])
    del pswept
    # cascade: prev holds the first half of the keys
    half = n // 2
    prev = bf_sweep.sweep_plain(torch.zeros_like(swept), canon[:half], valid[:half], bits)
    new = bf_sweep.cascade_segment(prev, torch.zeros_like(swept), canon, valid, bits)
    pnew = bf_sweep.sweep_plain(torch.zeros_like(swept), canon, valid, bits, prev=prev)
    err_c = require_equal("K5 cascade", [(new, pnew)])
    new_words = int((new != 0).sum())
    del pnew
    cascade = dict(
        max_abs_err=err_c,
        plain_ms=cuda_time_ms(
            lambda: bf_sweep.sweep_plain(new, canon, valid, bits, prev=prev), 2),
        # keys once, prev's hit words read, new's written words read and written
        bound_ms=(9 * n + 4 * hit_words + 8 * new_words) / HBM_BYTES_PER_S * 1e3,
        shape=f"{n} keys into 2^{bits} bits over a prev of {half} keys "
              f"({new_words} words of new set)",
    )
    # a single-cell filter (2^16 bits) and an all-in-one-cell segment of
    # a 2^32-bit filter, on 2^22 of the keys
    sub = min(1 << 22, n)
    c_sub, v_sub = canon[:sub].contiguous(), valid[:sub].contiguous()
    rows, small = {}, {}
    for label, sbits, keys in (("single_cell_2^16", 16, c_sub),
                               ("one_cell_of_2^32", bits, c_sub & ((1 << 19) - 1))):
        sw = torch.zeros((1 << sbits) // 32, dtype=torch.int32, device=dev)
        bf_sweep.insert_segment(sw, keys, v_sub, sbits)
        e = require_equal(f"K5 {label}", [
            (sw, bf_sweep.sweep_plain(torch.zeros_like(sw), keys, v_sub, sbits))])
        hits = torch.unique(bloom.bit_index(keys[v_sub], sbits)[0]).numel()
        rows[label] = (sw, keys, v_sub, sbits)
        small[label] = dict(
            max_abs_err=e,
            plain_ms=cuda_time_ms(lambda: bf_sweep.sweep_plain(sw, keys, v_sub, sbits), 2),
            bound_ms=(9 * sub + 8 * hits) / HBM_BYTES_PER_S * 1e3,
            shape=f"{sub} keys into 2^{sbits} bits ({hits} distinct words hit)",
        )
    edge_cases = k5_edges(torch, bf_sweep, canon, valid)
    for label, (sw, keys, v, sbits) in rows.items():
        small[label].update(
            ms=device_ms(lambda: bf_sweep.insert_segment(sw, keys, v, sbits), 5),
            wrapper_ms=cuda_time_ms(lambda: bf_sweep.insert_segment(sw, keys, v, sbits), 5),
        )
    # where the time goes: the binning (count, scan with the slice plan,
    # partition passes) and the apply (per-cell shared-memory OR), each
    # timed alone
    bins = bf_sweep.bin_keys(canon, valid, bits)
    stage_ms = dict(
        bin=device_ms(lambda: bf_sweep.bin_keys(canon, valid, bits)),
        apply=device_ms(lambda: bf_sweep.apply_bins(swept, *bins, bits)),
    )
    bins = bf_sweep.bin_keys(canon, valid, bits, cascade=True)
    cascade.update(
        ms=device_ms(lambda: bf_sweep.cascade_segment(prev, new, canon, valid, bits)),
        wrapper_ms=cuda_time_ms(
            lambda: bf_sweep.cascade_segment(prev, new, canon, valid, bits), 10),
        stage_ms=dict(apply=device_ms(lambda: bf_sweep.apply_bins(new, *bins, bits, prev))),
    )
    del bins, prev, new, rows
    torch.cuda.empty_cache()
    return dict(
        max_abs_err=max(err, err_c, *(d["max_abs_err"] for d in small.values())),
        ms=device_ms(lambda: bf_sweep.insert_segment(swept, canon, valid, bits)),
        wrapper_ms=cuda_time_ms(lambda: bf_sweep.insert_segment(swept, canon, valid, bits), 10),
        plain_ms=cuda_time_ms(
            lambda: bf_sweep.sweep_plain(torch.zeros_like(k4_words), canon, valid, bits), 2),
        bound_ms=k4_bound,
        shape=f"{n} keys into 2^{bits} bits ({hit_words} distinct words hit), insert",
        stage_ms=stage_ms,
        k4_ms_same_shape=k4_ms,
        cascade=cascade,
        edge_cases=edge_cases,
        **small,
    )


INV_START = int(GENOME_BP * 0.4)


def run_cli_path(torch, tmp: str, name: str, path: str, args, info: dict) -> str:
    """One 2 x 100 Mbp CLI run in its own directory as the given path:
    launches, launch sizes, stage times, peak device memory, and the
    inversion's block. Returns the blocks TSV path."""
    work = os.path.join(tmp, name)
    os.makedirs(work)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out, launches, shapes = drive_path(
        torch, path, lambda: run_cli(work, [*args, "-d", "1", "-p", "smoke", "--benchmark"]))
    info["cli_s"] = round(time.perf_counter() - t0, 3)
    info["launches"] = launches
    info["launch_shapes"] = shapes
    # the run's peak: reset above, and nothing in the port resets it
    info["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated()
    info["stages"] = read_stages(os.path.join(work, "smoke.time.tsv"))
    rows = read_blocks(out)
    info["blocks"] = len({r["id"] for r in rows})
    info["inversion_block"] = find_inversion(rows, INV_START, INV_START + INV_BP)
    return out


def phase_main_path(torch, tmp: str, info: dict):
    t0 = time.perf_counter()
    fa, fb = make_pair(tmp, GENOME_BP, INV_START, INV_BP, 0.001, SEED)
    info["generate_s"] = round(time.perf_counter() - t0, 3)
    out = run_cli_path(torch, tmp, "main", "main", [fa, fb], info)
    return info["launches"], info["launch_shapes"], fa, fb, out


def phase_sweep_path(torch, dev, tmp: str, fa: str, fb: str, main_out: str, info: dict):
    """The cascade through K5 against the cascade through K4 on the
    2 x 100 Mbp genomes, then the CLI with the sweep on. Returns the K4
    cascade's filter and the sweep run's launches."""
    from ntsynt_tpu_torch.io.fasta import read_fasta
    from ntsynt_tpu_torch.ops import bf_build

    genomes = [read_fasta(fa), read_fasta(fb)]
    with env_set("NTSYNT_BF_SWEEP", "1"):
        t0 = time.perf_counter()
        swept, info["build_launches"], _ = drive_path(
            torch, "sweep_build", lambda: bf_build.build_common_bf(genomes, 24, device=dev))
        info["build_common_bf_sweep_s"] = round(time.perf_counter() - t0, 3)
    with env_set("NTSYNT_BF_SWEEP", None):
        t0 = time.perf_counter()
        cascade = bf_build.build_common_bf(genomes, 24, device=dev)
        torch.cuda.synchronize()
        info["build_common_bf_atomic_or_s"] = round(time.perf_counter() - t0, 3)
    if info["build_launches"]["bf_insert"] != 0:
        raise AssertionError("the sweep cascade launched the atomic-OR insert")
    if not torch.equal(swept.words, cascade.words):
        raise AssertionError("the sweep cascade's words differ from the atomic-OR cascade's")
    info["cascade_words_equal"] = True
    info["num_bits"] = swept.num_bits
    info["popcount"] = swept.popcount()
    del genomes, swept
    torch.cuda.empty_cache()
    with env_set("NTSYNT_BF_SWEEP", "1"):
        out = run_cli_path(torch, tmp, "sweep", "sweep", [fa, fb], info)
    if info["launches"]["bf_insert"] != 0:
        raise AssertionError("the sweep CLI run launched the atomic-OR insert")
    with open(out, "rb") as f1, open(main_out, "rb") as f2:
        if f1.read() != f2.read():
            raise AssertionError("the sweep CLI run's blocks differ from the default run's")
    info["blocks_equal_main"] = True
    return cascade, info["launches"]


def phase_make_bf(torch, dev, tmp: str, fa: str, fb: str, cascade, info: dict) -> None:
    """make-common-bf --format btllib, reloaded through load_bf."""
    from ntsynt_tpu_torch import make_bf
    from ntsynt_tpu_torch.ops.bloom import BloomFilter, load_bf

    prefix = os.path.join(tmp, "common")
    t0 = time.perf_counter()
    if make_bf.common_main(["--genome", fb, fa, "-k", "24", "-p", prefix, "--format", "btllib"]):
        raise AssertionError("make-common-bf failed")
    info["make_common_bf_cli_s"] = round(time.perf_counter() - t0, 3)
    with open(prefix + ".bf", "rb") as fin:
        if not fin.read(24).startswith(b"[BTLKmerBloomFilter_v6]"):
            raise AssertionError("make-common-bf did not write a btllib container")
    info["bytes"] = os.path.getsize(prefix + ".bf")
    t0 = time.perf_counter()
    bf = load_bf(prefix + ".bf", device=dev)
    info["load_bf_s"] = round(time.perf_counter() - t0, 3)
    if not isinstance(bf, BloomFilter) or not torch.equal(bf.words, cascade.words):
        raise AssertionError("the reloaded btllib filter differs from the cascade")
    info["reloaded_words_equal"] = True
    os.remove(prefix + ".bf")


def k3_library(torch, arg, minv, legit):
    """K3's function by PyTorch's boolean-mask indexing (the yardstick,
    used nowhere in the port): the legit bits unpacked by a gather and a
    shift, compact_plain's flags, then the flagged
    windows' (position, hash) pairs in one mask index, which syncs once
    to size its output as K3's wrapper does."""
    from ntsynt_tpu_torch.ops.nthash import SENTINEL

    idx = torch.arange(arg.shape[0], device=arg.device)
    live = ((legit[idx >> 3] >> (idx & 7).to(torch.uint8)) & 1).bool() & (minv != SENTINEL)
    flag = live.clone()
    flag[1:] &= ~live[:-1] | (arg[1:] != arg[:-1])
    pairs = torch.stack([arg, minv])[:, flag]
    return pairs[0], pairs[1]


def time_compact(torch, sketch_device, arg, minv, legit, reps: int = 10) -> dict:
    """K3 vs its plain version on these windows: check, then its device
    time (ms: compact_launch, which does not sync, in a CUDA graph) and
    its wrapper's (wrapper_ms: a loop of calls, each syncing once), both
    writing into buffers made beforehand, as the sketch's in-place call
    allocates none; and the library expression (k3_library), checked
    against the plain version and timed as a loop of calls."""
    pos, hsh = sketch_device.compact_minimizers(arg, minv, legit)
    plain = sketch_device.compact_plain(arg, minv, legit)
    err = require_equal(f"K3 {arg.shape[0]} windows", zip((pos, hsh), plain))
    require_equal(f"K3's library expression, {arg.shape[0]} windows",
                  zip(k3_library(torch, arg, minv, legit), plain))
    del plain
    nw, m = arg.shape[0], pos.shape[0]
    out = (torch.empty_like(arg), torch.empty_like(minv))
    return dict(
        max_abs_err=err,
        ms=device_ms(lambda: sketch_device.compact_launch(arg, minv, legit, out=out), reps),
        wrapper_ms=cuda_time_ms(
            lambda: sketch_device.compact_minimizers(arg, minv, legit, out=out), reps),
        plain_ms=cuda_time_ms(lambda: sketch_device.compact_plain(arg, minv, legit), 2),
        library_ms=cuda_time_ms(lambda: k3_library(torch, arg, minv, legit), reps),
        bound_ms=(16 * nw + -(-nw // 8) + 16 * m) / HBM_BYTES_PER_S * 1e3,
        shape=f"{nw} windows -> {m} minimizers",
    )


def phase_winmin_refine(torch, dev, shapes, kernels: dict, info: dict) -> None:
    """K2 vs its plain version at the largest key count the main path
    gave it for each refinement w, on keys hashed from seeded codes; and
    w=10 (the last round of the -d < 1 preset) at the smallest of those
    counts. K3 compacts each of those K2 outputs (every window legit):
    the window counts of the refinement rounds' K3 launches."""
    from ntsynt_tpu_torch.ops import nthash, sketch_device, winmin

    main_w = max(w for _, w in shapes["winmin"])
    largest = {}
    for n, w in shapes["winmin"]:
        if w != main_w:
            largest[w] = max(largest.get(w, 0), n)
    if not largest:
        raise AssertionError("the main path ran no refinement round")
    largest[10] = min(largest.values())
    rng = np.random.default_rng(SEED + 1)
    k = 24
    by_w = kernels["winmin"]["by_w"]
    k3_refine = kernels["compact"].setdefault("refine", {})
    for w, n in sorted(largest.items(), reverse=True):
        codes = torch.from_numpy(rng.integers(0, 4, n + k - 1, dtype=np.uint8)).to(dev)
        keys = nthash.hash_kmers(codes, k, n)[0]
        by_w[str(w)] = time_winmin(winmin, keys, w)
        arg, minv = winmin.window_argmin(keys, w)
        k3_refine[str(w)] = time_compact(torch, sketch_device, arg, minv,
                                         legit_bits(torch, np.ones(arg.shape[0], bool)), 20)
        del codes, keys, arg, minv
    info["by_w"] = {w: by_w[str(w)] for w in sorted(largest, reverse=True)}
    info["compact_by_w"] = {w: k3_refine[str(w)] for w in sorted(largest, reverse=True)}
    info["compact_launch_windows"] = [nw for (nw,) in shapes["compact"]]


def cli_card_vs_cpu(torch, root: str, case: str, args) -> dict:
    """The CLI on args from root/<case>_cuda with --device cuda and from
    root/<case>_cpu with --device cpu: every artifact must be
    byte-identical. Returns their names, the blocks' rows, each run's
    seconds and the card run's launches."""
    outs, out = {}, {}
    for device in ("cuda", "cpu"):
        work = os.path.join(root, f"{case}_{device}")
        os.makedirs(work)
        argv = [*args, "--device", device]
        t0 = time.perf_counter()
        if device == "cuda":
            _, out["launches"], _ = drive_path(torch, "main", lambda: run_cli(work, argv))
        else:
            run_cli(work, argv)
        out[f"{device}_s"] = round(time.perf_counter() - t0, 3)
        outs[device] = {f: open(os.path.join(work, f), "rb").read()
                        for f in sorted(os.listdir(work))}
    if sorted(outs["cuda"]) != sorted(outs["cpu"]):
        raise AssertionError(
            f"{case}: artifact sets differ: {sorted(outs['cuda'])} vs {sorted(outs['cpu'])}")
    for f, data in outs["cuda"].items():
        if outs["cpu"][f] != data:
            raise AssertionError(f"{case}: {f} differs between --device cuda and --device cpu")
    out.update(artifacts_identical=sorted(outs["cuda"]),
               blocks_rows=outs["cuda"]["smoke.synteny_blocks.tsv"].count(b"\n"))
    return out


def phase_card_vs_cpu(torch, tmp: str, info: dict) -> None:
    """The 200 kb inversion scenario of the CPU tests (with a tandem
    repeat for the repeat filter), on cuda and cpu, without and with each
    --filter mode."""
    rng = np.random.default_rng(1234)
    base = rng.integers(0, 4, 200_000).astype(np.uint8)
    base[150_000:160_000] = base[140_000:150_000]
    inv = base.copy()
    inv[80_000:130_000] = inv[80_000:130_000][::-1] ^ 3
    small = os.path.join(tmp, "small")
    os.makedirs(small)
    fa = write_fasta(os.path.join(small, "ref.fa"), [("chr1", base)], width=70)
    fb = write_fasta(os.path.join(small, "inv.fa"), [("chr1", inv)], width=70)
    args = [fa, fb, "-d", "1", "-k", "24", "-w", "100", "--w_rounds", "50", "10",
            "-b", "500", "--indel", "500", "--merge", "3000", "-p", "smoke"]
    for case, extra in (("default", []), ("filter_Indexlr", ["--filter", "Indexlr"]),
                        ("filter_Filter", ["--filter", "Filter"])):
        info[case] = cli_card_vs_cpu(torch, small, case, args + extra)


GENOME_FIELDS = ("lengths", "offsets", "codes", "raw", "fai_offsets", "fai_linebases",
                 "fai_linewidth")


def same_genome(a, b, tmp: str) -> bool:
    """Every field of two PackedGenomes and their .fai bytes are equal."""
    from ntsynt_tpu_torch.io.fasta import write_fai

    if a.contig_names != b.contig_names:
        return False
    for f in GENOME_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        if x.dtype != y.dtype or x.shape != y.shape or not np.array_equal(x, y):
            return False
    fais = [write_fai(g, os.path.join(tmp, f"same_genome_{i}.fai")) for i, g in enumerate((a, b))]
    same = open(fais[0], "rb").read() == open(fais[1], "rb").read()
    for f in fais:
        os.remove(f)
    return same


def phase_host_native(tmp: str, fa: str, info: dict) -> None:
    """Genome A (one 100 Mbp contig) and a copy split into 12 contigs, as
    a chromosome set is: the native reader at one thread and at
    os.cpu_count() threads against the NumPy reader. Pass 2 of the native
    parse is parallel over contigs, so the one-contig file shows the
    native-vs-NumPy gap and the 12-contig one the threads."""
    from ntsynt_tpu_torch.io import fasta as fio

    rng = np.random.default_rng(SEED + 2)
    threads = os.cpu_count() or 1
    info["cpu_count"] = threads
    t0 = time.perf_counter()
    ref = fio.read_fasta(fa, native=False)
    numpy_s = time.perf_counter() - t0
    cuts = np.sort(rng.choice(ref.total_bases - 1, 11, replace=False) + 1)
    pieces = np.split(ref.codes, cuts)
    fa12 = write_fasta(os.path.join(tmp, "genomeA12.fa"),
                       [(f"chr{i + 1}", c) for i, c in enumerate(pieces)])
    info["contig_lengths_12"] = [len(c) for c in pieces]
    del pieces
    for label, path in (("one_contig", fa), ("12_contigs", fa12)):
        row = {}
        if label != "one_contig":
            t0 = time.perf_counter()
            ref = fio.read_fasta(path, native=False)
            numpy_s = time.perf_counter() - t0
        row["numpy_s"] = round(numpy_s, 4)
        for t in (1, threads):
            t0 = time.perf_counter()
            g = fio.read_fasta(path, native=True, threads=t)
            row[f"native_t{t}_s"] = round(time.perf_counter() - t0, 4)
            if not same_genome(g, ref, tmp):
                raise AssertionError(f"host_native {label}: the native read at {t} threads "
                                     "differs from the NumPy read")
            del g
        row["bases"] = ref.total_bases
        row["identical"] = True
        info[label] = row
        del ref
    os.remove(fa12)


def walk_alone(n_nodes: int) -> dict:
    """MinimizerGraph.linear_paths on one chain of n_nodes, native and
    with NTSYNT_NO_NATIVE_WALK=1: seconds of each, paths equal."""
    from ntsynt_tpu_torch.graph.mxgraph import MinimizerGraph

    rng = np.random.default_rng(SEED + 3)
    chain = rng.permutation(np.arange(1, n_nodes + 1, dtype=np.uint64))
    g = MinimizerGraph.build([("a", [chain]), ("b", [chain])], {"a": 1, "b": 1})
    out, paths = {}, {}
    for label, value in (("native", None), ("numpy", "1")):
        with env_set("NTSYNT_NO_NATIVE_WALK", value):
            t0 = time.perf_counter()
            paths[label] = g.linear_paths()
            out[f"{label}_s"] = round(time.perf_counter() - t0, 4)
    if len(paths["native"]) != 1 or not all(
            np.array_equal(a, b) for a, b in zip(paths["native"], paths["numpy"])):
        raise AssertionError(f"walk on a {n_nodes}-node chain: native and NumPy paths differ")
    return out


def phase_walk(torch, tmp: str, fa: str, fb: str, main_out: str, main_info: dict,
               info: dict) -> None:
    """The main path's CLI run with NTSYNT_NO_NATIVE_WALK=1 (the NumPy
    pointer-doubling walk) must write the main path's blocks; the walk
    alone on chains of the main path's graph size and a gigabase
    genome's."""
    with env_set("NTSYNT_NO_NATIVE_WALK", "1"):
        out = run_cli_path(torch, tmp, "no_native_walk", "main", [fa, fb], info)
    with open(out, "rb") as f1, open(main_out, "rb") as f2:
        if f1.read() != f2.read():
            raise AssertionError(
                "the NTSYNT_NO_NATIVE_WALK run's blocks differ from the main path's")
    info["blocks_equal_main"] = True
    keep = ("synteny", "read_fasta:genomeA.fa", "read_fasta:genomeB.fa", "make_common_bf")
    info["stage_s"] = {
        "native_walk (main path)": {k: main_info["stages"][k]["s"] for k in keep},
        "numpy_walk": {k: info["stages"][k]["s"] for k in keep},
    }
    # 2L/w minimizers a genome: 2 x 10^5 at 100 Mbp, 2 x 10^6 at 1 Gbp (w=1000)
    info["walk_alone"] = {f"{n}_nodes": walk_alone(n) for n in (200_000, 2_000_000)}


def phase_sidecars(tmp: str, blocks_tsv: str, info: dict) -> None:
    """The sidecars on the main path's blocks TSV and .fai files."""
    from ntsynt_tpu_torch.analysis.stats import compute_stats
    from ntsynt_tpu_torch.viz import formats

    work = os.path.dirname(blocks_tsv)
    fais = [os.path.join(work, f"{g}.fai") for g in ("genomeA.fa", "genomeB.fa")]
    out = os.path.join(tmp, "sidecars")
    os.makedirs(out)
    seconds = {}  # per step; the phase's own "seconds" is its total

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        result = fn(*args)
        seconds[name] = round(time.perf_counter() - t0, 4)
        return result

    stats = timed("compute_stats", compute_stats, blocks_tsv, fais)
    lines = timed("sort_blocks", formats.sort_blocks, blocks_tsv, ["genomeB.fa", "genomeA.fa"])
    seq = timed("write_sequence_lengths", formats.write_sequence_lengths, fais,
                os.path.join(out, "viz"))
    links = timed("write_links", formats.write_links, blocks_tsv, os.path.join(out, "viz"),
                  10000, "genomeA.fa")
    paint = timed("write_chromosome_painting", formats.write_chromosome_painting, blocks_tsv,
                  "genomeA.fa", os.path.join(out, "painting.tsv"))
    if stats["Number_blocks"] <= 0 or stats["NG50_length"] <= 0 or not lines:
        raise AssertionError(f"sidecars: no blocks in the stats or sort_blocks: {stats}")
    for path in (seq, links, paint):
        with open(path) as fin:
            if sum(1 for _ in fin) < 2:
                raise AssertionError(f"sidecars: {os.path.basename(path)} holds no row")
    info.update(step_s=seconds, stats=stats, sorted_rows=len(lines))
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        info["plots"] = "not run: matplotlib is not installed"
        print("sidecars: the plots were not run: matplotlib is not installed", flush=True)
        return
    from ntsynt_tpu_torch.viz.plot import painting_plot, ribbon_plot

    pngs = [timed("ribbon_plot", ribbon_plot, seq, links, os.path.join(out, "ribbon.png")),
            timed("painting_plot", painting_plot, paint, os.path.join(out, "painting.png"))]
    info["plots"] = {os.path.basename(p): os.path.getsize(p) for p in pngs}


# ---------------------------------------------------------------------------
# the mesh path: parallel/multihost.py subprocesses, one per rank
# ---------------------------------------------------------------------------

MESH_KERNELS = PATH_KERNELS["main"]
LAUNCH_LINE = re.compile(r"\[multihost\] process (\d+) launches (\{.*\})")
PEAK_LINE = re.compile(r"\[multihost\] process (\d+) max_memory_allocated (\d+)")
FILTER_WORDS_LOG2 = 27  # 2^32 bits: the common filter at 100 Mbp, 512 MiB of int32 words


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def subprocess_env() -> dict:
    """This checkout on the path; NCCL and gloo on the loopback device
    alone."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, NCCL_SOCKET_IFNAME="lo", GLOO_SOCKET_IFNAME="lo")
    env["PYTHONPATH"] = os.pathsep.join([here] + [p for p in [env.get("PYTHONPATH")] if p])
    return env


def run_ranks(commands, workdirs, timeout: int):
    """Start one process per rank together, each in its own directory;
    wait up to timeout seconds for all. Returns [(returncode, output)];
    a rank still running at the timeout is killed and reported as None.
    No process outlives the call."""
    procs = [subprocess.Popen(cmd, cwd=wd, env=subprocess_env(), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd, wd in zip(commands, workdirs)]
    deadline = time.monotonic() + timeout
    results = []
    try:
        for p in procs:
            try:
                out, _ = p.communicate(timeout=max(deadline - time.monotonic(), 1))
                results.append((p.returncode, out))
            except subprocess.TimeoutExpired:
                p.kill()
                results.append((None, p.communicate()[0]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return results


def multihost_run(tmp: str, name: str, world: int, cli_args, backend=None,
                  timeout: int = 180):
    """world ranks of ``python -m ntsynt_tpu_torch.parallel.multihost``,
    rank r in tmp/name/rank<r> (made if missing, else run again in).
    Returns (results, workdirs, the seconds from their start to the last
    one's end)."""
    port = free_port()
    dirs = [os.path.join(tmp, name, f"rank{r}") for r in range(world)]
    commands = []
    for r, wd in enumerate(dirs):
        os.makedirs(wd, exist_ok=True)
        commands.append([sys.executable, "-m", "ntsynt_tpu_torch.parallel.multihost",
                         "--coordinator", f"localhost:{port}", "--num-processes", str(world),
                         "--process-id", str(r), *(["--backend", backend] if backend else []),
                         "--", *cli_args, "-d", "1", "-p", "smoke", "--benchmark"])
    t0 = time.perf_counter()
    results = run_ranks(commands, dirs, timeout)
    return results, dirs, round(time.perf_counter() - t0, 3)


def check_ranks(name: str, results, dirs, want_blocks: str, info: dict) -> None:
    """Every rank exited 0 and launched every kernel of the path on the
    card; rank 0's blocks equal want_blocks'; the other ranks wrote no
    file."""
    launches, peaks = [], []
    for r, (rc, out) in enumerate(results):
        if rc != 0:
            state = "hung and was killed" if rc is None else f"exited {rc}"
            raise AssertionError(f"mesh {name}: rank {r} {state}:\n{out[-3000:]}")
        m = [json.loads(g) for i, g in LAUNCH_LINE.findall(out) if int(i) == r]
        if len(m) != 1:
            raise AssertionError(f"mesh {name}: rank {r} printed no launch counts")
        for kernel in MESH_KERNELS:
            if m[0][kernel] <= 0:
                raise AssertionError(f"mesh {name}: rank {r} never launched {kernel}")
        launches.append(m[0])
        peak = [int(b) for i, b in PEAK_LINE.findall(out) if int(i) == r]
        if peak:
            peaks.append(peak[0])
        if r and os.listdir(dirs[r]):
            raise AssertionError(f"mesh {name}: rank {r} wrote {os.listdir(dirs[r])}")
    with open(os.path.join(dirs[0], "smoke.synteny_blocks.tsv"), "rb") as f1, \
            open(want_blocks, "rb") as f2:
        if f1.read() != f2.read():
            raise AssertionError(f"mesh {name}: rank 0's blocks differ from the single-device run's")
    info["launches_per_rank"] = launches
    if peaks:
        info["max_memory_allocated_per_rank"] = peaks
    info["rank0_stages_s"] = {k: v["s"] for k, v in
                              read_stages(os.path.join(dirs[0], "smoke.time.tsv")).items()}
    info["blocks_equal_single"] = True
    info["other_ranks_wrote_nothing"] = True


def rerun_ranks(tmp: str, name: str, world: int, cli_args, want_blocks: str, info: dict,
                backend=None, timeout: int = 180) -> None:
    """The multihost run ``name`` again in its directories: rank 0 finds
    its sketch TSVs fresh and reuses them (their mtimes stay), the other
    ranks, whose directories are empty, follow rank 0's choice and get
    its sketches; the blocks stay want_blocks'."""
    rank0 = os.path.join(tmp, name, "rank0")
    tsvs = [f for f in os.listdir(rank0) if f.endswith(".k24.w1000.tsv")]
    mtimes = {f: os.path.getmtime(os.path.join(rank0, f)) for f in tsvs}
    results, dirs, wall = multihost_run(tmp, name, world, cli_args, backend=backend,
                                        timeout=timeout)
    info["processes_s"] = wall
    check_ranks(f"{name} rerun", results, dirs, want_blocks, info)
    if len(tsvs) != 2 or {f: os.path.getmtime(os.path.join(rank0, f)) for f in tsvs} != mtimes:
        raise AssertionError(f"{name} rerun: rank 0 did not reuse its sketch TSVs {tsvs}")
    info["sketch_tsvs_reused"] = tsvs


def mesh_worker(rank: int, world: int, port: int, backend: str, fa: str, fb: str,
                out: str) -> int:
    """One rank of the collectives check (``chip_smoke.py --mesh-worker
    ...``, started by run_collectives): distributed_common_bf against the
    single-device cascade, then allreduce_or and _allreduce_dup on a
    2^32-bit filter of seeded random words, timed, against the OR and the
    twice-set bits of every rank's words; under gloo also the parts of
    the exchange (the words' trip through host memory, the collective on
    host tensors)."""
    import torch

    from ntsynt_tpu_torch.io.fasta import read_fasta
    from ntsynt_tpu_torch.ops import _kernels, bf_build
    from ntsynt_tpu_torch.parallel import mesh as pmesh
    from ntsynt_tpu_torch.parallel import multihost

    multihost.initialize(f"localhost:{port}", world, rank, backend=backend)
    mesh = pmesh.make_mesh()
    dev = mesh.device
    res = {"rank": rank, "backend": backend, "device": str(dev)}
    genomes = [read_fasta(fb), read_fasta(fa)]
    # the group's first all_to_all and all-gather (1 MiB), which set up
    # the ranks' connections, apart from the filter's
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pmesh.allreduce_or(torch.zeros(1 << 18, dtype=torch.int32, device=dev), mesh)
    torch.cuda.synchronize()
    res["first_allreduce_or_1mib_s"] = round(time.perf_counter() - t0, 4)
    _kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dist_bf = pmesh.distributed_common_bf(genomes, 24, mesh=mesh)
    torch.cuda.synchronize()
    res["distributed_common_bf_s"] = round(time.perf_counter() - t0, 4)
    res["launches"] = dict(_kernels.LAUNCHES)
    for kernel in ("nthash", "bf_insert"):
        if res["launches"][kernel] <= 0:
            raise AssertionError(f"rank {rank}: distributed_common_bf never launched {kernel}")
    # the single-device cascade on the same genomes, already read: the
    # work the ranks split
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    single = bf_build.build_common_bf(genomes, 24, device=dev)
    torch.cuda.synchronize()
    res["single_common_bf_s"] = round(time.perf_counter() - t0, 4)
    if not torch.equal(dist_bf.words, single.words):
        raise AssertionError(f"rank {rank}: distributed_common_bf differs from the single cascade")
    res.update(num_bits=dist_bf.num_bits, popcount=dist_bf.popcount(), words_equal_single=True)
    del dist_bf, single, genomes
    torch.cuda.empty_cache()

    n = 1 << FILTER_WORDS_LOG2
    words = []
    for r in range(world):
        gen = torch.Generator(device=dev).manual_seed(SEED + r)
        words.append(torch.randint(-(1 << 31), 1 << 31, (n,), dtype=torch.int32, device=dev,
                                   generator=gen))
    mine = words[rank]
    want_or = words[0].clone()
    want_twice = torch.zeros_like(want_or)
    for w in words[1:]:
        want_twice |= want_or & w
        want_or |= w
    del words
    reps = 3
    for name, fn in (("allreduce_or", lambda: pmesh.allreduce_or(mine, mesh)),
                     ("allreduce_dup", lambda: pmesh._allreduce_dup(mine, mesh))):
        got = fn()  # warm-up and check
        ok = (torch.equal(got, want_or) if name == "allreduce_or"
              else torch.equal(got[0], want_or) and torch.equal(got[1], want_twice))
        if not ok:
            raise AssertionError(f"rank {rank}: {name} differs from the OR of the ranks' words")
        del got
        torch.distributed.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        res[f"{name}_s"] = round((time.perf_counter() - t0) / reps, 4)
    if backend == "gloo":
        # the exchange's parts: the words' round trip through host memory
        # (pageable, as the mesh stages them) ...
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        host = mine.cpu()
        res["d2h_s"] = round(time.perf_counter() - t0, 4)
        t0 = time.perf_counter()
        host.to(dev)
        torch.cuda.synchronize()
        res["h2d_s"] = round(time.perf_counter() - t0, 4)
        # ... and the collectives alone on host tensors
        cmesh = pmesh.Mesh(mesh.group, mesh.rank, mesh.size, torch.device("cpu"))
        torch.distributed.barrier()
        t0 = time.perf_counter()
        for _ in range(reps):
            pmesh.allreduce_or(host, cmesh)
        res["allreduce_or_host_tensors_s"] = round((time.perf_counter() - t0) / reps, 4)
    res["filter_bytes"] = 4 * n
    with open(out, "w") as fout:
        json.dump(res, fout)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    return 0


def run_collectives(tmp: str, world: int, backend: str, fa: str, fb: str, info: dict) -> None:
    """world ranks of mesh_worker under backend; their results and the
    bytes each rank moves."""
    port = free_port()
    outs = [os.path.join(tmp, f"mesh_worker{r}.json") for r in range(world)]
    here = os.path.abspath(__file__)
    results = run_ranks(
        [[sys.executable, here, "--mesh-worker", str(r), str(world), str(port), backend, fa, fb,
          outs[r]] for r in range(world)], [tmp] * world, timeout=180)
    for r, (rc, out) in enumerate(results):
        if rc != 0:
            state = "hung and was killed" if rc is None else f"exited {rc}"
            raise AssertionError(f"mesh worker rank {r} {state}:\n{out[-3000:]}")
    workers = []
    for o in outs:
        with open(o) as fin:
            workers.append(json.load(fin))
    info["collectives"] = workers
    # bytes each rank sends for a filter of B bytes over D ranks: the
    # all_to_all (D-1)/D B, then one all-gather of (D-1)/D B per output;
    # under gloo the card's words also cross host memory
    b, d = workers[0]["filter_bytes"], world
    info["collective_bytes_sent_per_rank"] = {
        "allreduce_or": 2 * (d - 1) * b // d, "allreduce_dup": 3 * (d - 1) * b // d}
    if backend == "gloo":
        info["collective_bytes_staged_per_rank"] = {
            "allreduce_or": {"to_host": b + b // d, "to_card": 2 * b},
            "allreduce_dup": {"to_host": b + 2 * b // d, "to_card": 3 * b}}


MESH_REPEAT_SEG = 1 << 21  # the mesh's repeat-walk segment cap (parallel/mesh.py)


def walk_at_mesh_segment(torch, dev, tmp: str, name: str, fastas) -> str:
    """The blocks a mesh run with --filter Indexlr must write: the
    single-device CLI with the repeat filter of the single-device walk at
    the mesh's segment, bf_build.build_repeat_bf(..., chunk=2^21), saved
    byte-complete into the run's directory, where the CLI reuses it (its
    own walk is at 2^20). At the 2 x 100 Mbp shapes every rank's slab is
    whole 2^21-k-mer segments, so the mesh's filter is this one. Returns
    the blocks TSV path."""
    from ntsynt_tpu_torch.io.fasta import read_fasta
    from ntsynt_tpu_torch.ops import bf_build

    work = os.path.join(tmp, name)
    os.makedirs(work)
    path = os.path.join(work, "smoke.repeat.bf")
    rep = bf_build.build_repeat_bf([read_fasta(f) for f in fastas], 24, chunk=MESH_REPEAT_SEG,
                                   device=dev)
    rep.save(path)
    del rep
    torch.cuda.empty_cache()
    mtime = os.path.getmtime(path)
    out = run_cli(work, [*fastas, "--filter", "Indexlr", "-d", "1", "-p", "smoke"])
    if os.path.getmtime(path) != mtime:
        raise AssertionError(f"{name}: the CLI rebuilt the repeat filter instead of reusing it")
    return out


def phase_mesh(torch, dev, tmp: str, fa: str, fb: str, main_out: str, info: dict,
               kernels: dict) -> None:
    """The mesh path (parallel/mesh.py, parallel/multihost.py) on the one
    card, each rank a process of its own with its own timeout:
    a one-rank NCCL group through the multihost CLI; two ranks sharing the
    card under NCCL (expected to be refused; what NCCL says is printed),
    then under gloo on the default path and with --filter Indexlr (held
    to walk_at_mesh_segment's blocks), each
    rank's kernels on the card, and the default run again in its
    directories (a rerun that reuses rank 0's sketch TSVs); the two-rank
    common filter against the
    single cascade; allreduce_or and _allreduce_dup on the 2^32-bit
    filter."""
    results, dirs, wall = multihost_run(tmp, "mesh_nccl_1", 1, [fa, fb])
    if "(cuda, nccl)" not in results[0][1]:
        raise AssertionError(f"mesh nccl_1: not a cuda/nccl rank:\n{results[0][1][-3000:]}")
    info["nccl_one_rank"] = row = {"processes_s": wall}
    check_ranks("nccl_1", results, dirs, main_out, row)

    results, dirs, _ = multihost_run(tmp, "mesh_nccl_2", 2, [fa, fb], timeout=120)
    said = [line for rc, out in results for line in out.splitlines()
            if re.search(r"(?i)nccl|duplicate|error", line)]
    if any(rc is None for rc, _ in results):
        raise AssertionError("mesh nccl_2: a rank hung and was killed:\n" + "\n".join(said[-6:]))
    if all(rc == 0 for rc, _ in results):
        info["nccl_two_ranks_one_card"] = "ran"
        check_ranks("nccl_2", results, dirs, main_out, {})
    elif not any(re.search(r"Duplicate GPU|ncclInvalidUsage", out) for _, out in results):
        raise AssertionError("mesh nccl_2: a rank failed, and not by NCCL's refusal of two ranks "
                             "on one card:\n" + "\n".join(out[-2000:] for _, out in results))
    else:
        info["nccl_two_ranks_one_card"] = {
            "refused": True, "returncodes": [rc for rc, _ in results],
            "said": said[-6:]}
        print("mesh: NCCL refused two ranks on one card:", *said[-6:], sep="\n  ", flush=True)

    t0 = time.perf_counter()
    indexlr_out = walk_at_mesh_segment(torch, dev, tmp, "single_indexlr_seg21", [fa, fb])
    info["single_indexlr_at_mesh_segment_s"] = round(time.perf_counter() - t0, 3)
    # each run's timeout is about seven times its time on the card (PERF.md §5)
    for name, args, want, timeout in (
            ("gloo_2", [fa, fb], main_out, 180),
            ("gloo_2_indexlr", [fa, fb, "--filter", "Indexlr"], indexlr_out, 240)):
        results, dirs, wall = multihost_run(tmp, f"mesh_{name}", 2, args, backend="gloo",
                                            timeout=timeout)
        info[name] = row = {"processes_s": wall}
        check_ranks(name, results, dirs, want, row)
    info["gloo_2_rerun"] = {}
    rerun_ranks(tmp, "mesh_gloo_2", 2, [fa, fb], main_out, info["gloo_2_rerun"], backend="gloo")

    run_collectives(tmp, 2, "gloo", fa, fb, info)
    for name in MESH_KERNELS:
        kernels[name]["mesh_launches"] = [row[name] for row in info["gloo_2"]["launches_per_rank"]]


# ---------------------------------------------------------------------------
# the gigabase phase: bench.py's 3 x 1 Gbp genomes through the CLI, the
# same run with the cascade's streams released, and a stream past 2^31
# ---------------------------------------------------------------------------

GIGA_SEED = 20260817  # bench.py's
GIGA_BP = 1_000_000_000
GIGA_GENOMES = 3
DIVERGENCE = 0.001
GIGA_INV_START = int(GIGA_BP * 0.4)
GIGA_INV_BP = GIGA_BP // 2000  # 500 kb
GIGA_INV_TOL = 50_000  # find_inversion's 5 kb for 50 kb, scaled to 500 kb
# check c: two 1.1 Gbp contigs, then a 4 Mbp tail past stream offset 2^31
BIG_CONTIG_BP = 1_100_000_000
TAIL_BP = 4_000_000
TAIL_PAST = 1 << 31  # where int32 stream offsets wrap
SEG = 1 << 26  # k-mers (windows) a cascade (sketch) segment: ops/bf_build, ops/sketch_device


def _write_fasta(path: str, g: np.ndarray, step: int = 80):
    """bench.py's _write_fasta (copied: bench.py imports jax)."""
    dec = np.frombuffer(b"ACGT", dtype=np.uint8)
    raw = dec[g]
    pad = (-len(raw)) % step
    body = np.full(((len(raw) + pad) // step, step + 1), ord("\n"), dtype=np.uint8)
    body[:, :step] = np.concatenate([raw, np.full(pad, ord("A"), np.uint8)]).reshape(
        -1, step
    )
    with open(path, "wb") as f:
        f.write(b">chr1\n")
        f.write(body.tobytes())


def _gen_genomes(tmp, n_genomes: int, length: int, keep: bool = False):
    """bench.py's _gen_genomes (copied: bench.py imports jax): genome A
    and n-1 copies with 0.1% SNPs; copy 1 also carries a length/2000
    inversion at 0.4 L. With keep, returns (paths, the genomes' codes)."""
    rng = np.random.default_rng(GIGA_SEED)
    base = rng.integers(0, 4, length, dtype=np.uint8)
    paths, kept = [], [base]
    p0 = os.path.join(tmp, "benchA.fa")
    _write_fasta(p0, base)
    paths.append(p0)
    inv_len = max(length // 2000, 1000)
    for gi in range(1, n_genomes):
        mut = base.copy()
        n_snp = int(rng.binomial(length, DIVERGENCE))
        pos = rng.integers(0, length, n_snp)
        mut[pos] = (mut[pos] + rng.integers(1, 4, n_snp, dtype=np.uint8)) % 4
        if gi == 1:
            s = int(length * 0.4)
            e = s + inv_len
            mut[s:e] = mut[s:e][::-1] ^ 3
        p = os.path.join(tmp, f"bench{chr(ord('B') + gi - 1)}.fa")
        _write_fasta(p, mut)
        paths.append(p)
        if keep:
            kept.append(mut)
        del mut, pos
    del base
    return (paths, kept) if keep else paths


def segment_launches(contig_bp: int, k: int, w: int, bits_log2: int) -> dict:
    """The launch sizes (as _kernels.SHAPES records them) of one
    one-contig genome's cascade level and main sketch on the default
    path: its DeviceStream is the contig and w + k N codes; the cascade
    hashes and inserts its k-mers, the sketch hashes, scans and compacts
    its windows, SEG a segment."""
    total = contig_bp + w + k
    n_kmers, n_win = total - k + 1, total - (w + k - 1) + 1
    out = {"nthash": [], "winmin": [], "compact": [], "bf_insert": []}
    for s in range(0, n_kmers, SEG):
        m = min(SEG, n_kmers - s)
        out["nthash"].append((m, k))
        out["bf_insert"].append((m, bits_log2))
    for s in range(0, n_win, SEG):
        m = min(SEG, n_win - s)
        out["nthash"].append((m + w - 1, k))
        out["winmin"].append((m + w - 1, w))
        out["compact"].append((m,))
    return out


def check_gigabase_launches(launches: dict, shapes: dict, n_genomes: int, contig_bp: int,
                            bits_log2: int, w: int = 1000, label: str = "gigabase") -> dict:
    """A run's K1-K4 launches on n_genomes one-contig genomes of
    contig_bp against segment_launches: K4's and K2's at the main w are
    exactly the segments'; K1 and K3 launch once more for each
    refinement-round K2 launch (w other than the main one), whose sizes
    depend on the blocks. Returns the expected counts."""
    from collections import Counter

    want = {name: Counter() for name in ("nthash", "winmin", "compact", "bf_insert")}
    for _ in range(n_genomes):
        for name, sizes in segment_launches(contig_bp, 24, w, bits_log2).items():
            want[name].update(sizes)
    got = {name: Counter(tuple(x) for x in shapes[name]) for name in want}
    main_k2 = Counter({s: c for s, c in got["winmin"].items() if s[1] == w})
    refine = sum(got["winmin"].values()) - sum(main_k2.values())
    if got["bf_insert"] != want["bf_insert"] or main_k2 != want["winmin"]:
        raise AssertionError(f"{label}: K4 launches {dict(got['bf_insert'])} and K2 launches "
                             f"at w={w} {dict(main_k2)}, want {dict(want['bf_insert'])} and "
                             f"{dict(want['winmin'])}")
    for name in ("nthash", "compact"):
        missing = want[name] - got[name]
        extra = sum(got[name].values()) - sum(want[name].values())
        if missing or extra != refine:
            raise AssertionError(f"{label}: {name} lacks {dict(missing)} or launched {extra} "
                                 f"times beyond the segments, want {refine} (refinement)")
    expected = {name: sum(want[name].values()) for name in want}
    for name in ("nthash", "winmin", "compact"):
        expected[name] += refine
    if {name: launches[name] for name in expected} != expected:
        raise AssertionError(f"{label}: launches {launches}, want {expected}")
    return dict(expected, refinement_k2_launches=refine)


def run_cli_worker(work: str, args, timeout: int) -> dict:
    """The port's CLI in a process of its own (``chip_smoke.py
    --cli-worker``), from work: its kernel launches and their sizes,
    torch.cuda.max_memory_allocated over the run and each cascade level's
    occupancy."""
    out = os.path.join(work, "worker.json")
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--cli-worker", out, "--",
                           *args], cwd=work, env=subprocess_env(), capture_output=True, text=True,
                          timeout=timeout)
    if proc.returncode != 0:
        raise AssertionError(f"CLI worker exited {proc.returncode}:\n"
                             f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    with open(out) as fin:
        res = json.load(fin)
    # each cascade level's occupancy, as the run logs it (bf_build)
    res["occupancy"] = [float(x) for x in OCCUPANCY_LINE.findall(proc.stdout)]
    return res


def mem_total_bytes() -> int:
    with open("/proc/meminfo") as fin:
        for line in fin:
            if line.startswith("MemTotal:"):
                return int(line.split()[1]) * 1024
    raise AssertionError("no MemTotal in /proc/meminfo")


def cli_worker(out: str, args) -> int:
    """``chip_smoke.py --cli-worker OUT -- ARGS``: the port's CLI on ARGS
    with every kernel count at 0 and the device peak reset; writes the
    launches, their sizes and the peak to OUT."""
    import torch

    from ntsynt_tpu_torch.cli import main as cli_main
    from ntsynt_tpu_torch.ops import _kernels

    _kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    rc = cli_main(args)
    torch.cuda.synchronize()
    with open(out, "w") as fout:
        json.dump({"rc": rc, "launches": dict(_kernels.LAUNCHES),
                   "shapes": {k: list(v) for k, v in _kernels.SHAPES.items()},
                   "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()}, fout)
    return rc


def release_forced_run(torch, dev, work: str, paths, num_bits: int, info: dict) -> None:
    """Run a's CLI in this process (NtSyntPipeline(cfg).run() on the same
    config), from work, with stream_budget patched
    one byte below release_plan's projection, so that the plan releases
    the stream of every genome above the line after its cascade level
    and the sketch builds it again. Records the streams built and the
    releases, in order."""
    from ntsynt_tpu_torch.core import pipeline as tpipe
    from ntsynt_tpu_torch.ops import bf_build
    from ntsynt_tpu_torch.ops import sketch as sketch_ops

    sizes = {os.path.basename(p): os.path.getsize(p) for p in paths}
    projection = 2 * (num_bits // 8) + sum(int(b * tpipe.STREAM_BYTES_PER_BASE)
                                           for b in sizes.values())
    info["projection_bytes"] = projection
    info["card_budget_bytes"] = tpipe.stream_budget(dev)
    info["card_would_release"] = sorted(tpipe.release_plan(sizes, num_bits,
                                                           info["card_budget_bytes"]))
    events = []
    stream_cls, cascade, budget = (sketch_ops.DeviceStream, bf_build.build_common_bf_from_device,
                                   tpipe.stream_budget)

    class RecordingStream(stream_cls):
        def __init__(self, genome, *a, **kw):
            events.append(("stream", genome.name))
            super().__init__(genome, *a, **kw)

    def recording_cascade(*a, release=None, **kw):
        def rel(name):
            events.append(("release", name))
            release(name)
        return cascade(*a, release=rel if release else None, **kw)

    sketch_ops.DeviceStream = RecordingStream
    bf_build.build_common_bf_from_device = recording_cascade
    tpipe.stream_budget = lambda device: projection - 1
    try:
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        _, info["launches"], _ = drive_path(torch, "main", lambda: run_cli(
            work, [*paths, "-d", "1", "-p", "smoke", "--benchmark"]))
        info["run_s"] = round(time.perf_counter() - t0, 3)
        info["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated() - base
        info["allocated_before_bytes"] = base
    finally:
        sketch_ops.DeviceStream, bf_build.build_common_bf_from_device = stream_cls, cascade
        tpipe.stream_budget = budget
    names = sorted(sizes)
    want = []
    for n in names:
        want += [("stream", n), ("release", n)]
    want += [("stream", n) for n in names]
    if events[: len(want)] != want:
        raise AssertionError(f"gigabase b: streams and releases {events[:12]}, want {want}")
    info["released_and_rebuilt"] = names


def time_upload(torch, dev, genome, k: int = 24, w: int = 1000) -> dict:
    """One genome's stream sent to the card as the pipeline sends it
    (DeviceStream: packed on the host a group at a time, copied and
    unpacked on the card), then its legit bits: the seconds until the
    codes have landed, the bytes sent, and the bytes the stream holds."""
    from ntsynt_tpu_torch.ops import _kernels
    from ntsynt_tpu_torch.ops import sketch as sketch_ops

    first = len(_kernels.SHAPES["unpack"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ds = sketch_ops.DeviceStream(genome, k, w, dev)
    codes = ds.codes
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    legit = ds.legit
    torch.cuda.synchronize()
    sizes = [n for (n,) in _kernels.SHAPES["unpack"][first:]]
    sent = sum(3 * n // 8 for n in sizes)
    out = dict(stream_codes=ds.n, groups=len(sizes), sent_bytes=sent,
               sent_bytes_per_base=sent / genome.total_bases, upload_s=round(upload_s, 3),
               legit_bits_s=round(time.perf_counter() - t0, 3),
               held_bytes=codes.numel() + legit.numel(),
               held_bytes_per_base=(codes.numel() + legit.numel()) / genome.total_bases)
    if len(sizes) != ds.n_groups:
        raise AssertionError(f"the upload of {genome.name} unpacked {len(sizes)} groups, "
                             f"want {ds.n_groups}")
    del ds, codes, legit
    torch.cuda.empty_cache()
    return out


def sent_bytes(shapes: dict) -> dict:
    """What a run sent to the card: its unpack launches and the packed
    bytes they read (3/8 of a byte a code)."""
    return dict(unpack_launches=len(shapes["unpack"]),
                sent_bytes=sum(3 * n // 8 for (n,) in shapes["unpack"]))


def packed_genome(name: str, codes: np.ndarray, lengths):
    """A PackedGenome of in-memory contigs laid end to end in codes."""
    from ntsynt_tpu_torch.io.fasta import PackedGenome

    lengths = np.asarray(lengths, dtype=np.int64)
    zeros = np.zeros(len(lengths), dtype=np.int64)
    return PackedGenome(path=name, name=name, contig_names=[f"c{i}" for i in range(len(lengths))],
                        lengths=lengths,
                        offsets=np.concatenate([[0], np.cumsum(lengths)[:-1]]).astype(np.int64),
                        codes=codes, raw=None, fai_offsets=zeros, fai_linebases=zeros,
                        fai_linewidth=zeros)


def past_2_31_checks(torch, dev, info: dict) -> None:
    """Checks c and d: genome G (two 1.1 Gbp contigs and a 4 Mbp tail
    starting past stream offset 2^31) and H, G with 0.1% SNPs. The card
    builds the cascade over [G, H] and sketches G; its minimizers on the
    tail must be the CPU port's sketch of the tail alone probed against a
    CPU copy of the filter's words (minimizers never cross a contig).
    The mesh at D = 1 must give the card's sketch of G."""
    from ntsynt_tpu_torch.ops import bf_build, bloom
    from ntsynt_tpu_torch.ops import sketch as sketch_ops
    from ntsynt_tpu_torch.parallel import mesh as pmesh

    k, w = 24, 1000
    lengths = [BIG_CONTIG_BP, BIG_CONTIG_BP, TAIL_BP]
    t0 = time.perf_counter()
    rng = np.random.default_rng(GIGA_SEED + 1)
    g_codes = rng.integers(0, 4, sum(lengths), dtype=np.uint8)
    h_codes = g_codes.copy()
    n_snp = int(rng.binomial(len(h_codes), DIVERGENCE))
    pos = rng.integers(0, len(h_codes), n_snp)
    h_codes[pos] = (h_codes[pos] + rng.integers(1, 4, n_snp, dtype=np.uint8)) % 4
    del pos
    g, h = packed_genome("G", g_codes, lengths), packed_genome("H", h_codes, lengths)
    info["generate_s"] = round(time.perf_counter() - t0, 3)
    stream = sketch_ops._Stream(g, k, w)
    tail_start = int(stream.starts[2])
    if tail_start <= TAIL_PAST:
        raise AssertionError(f"gigabase c: the tail starts at {tail_start}, not past {TAIL_PAST}")
    info.update(stream_length=stream.total, tail_start=tail_start)
    info["upload"] = time_upload(torch, dev, g, k, w)

    def on_card():
        bf = bf_build.build_common_bf([g, h], k, device=dev)
        return bf, sketch_ops.sketch_genome(g, k, w, common_bf=bf, device=dev)

    t0 = time.perf_counter()
    (bf, sk), info["launches"], _ = drive_path(torch, "main", on_card)
    info["card_s"] = round(time.perf_counter() - t0, 3)
    del h, h_codes
    info["num_bits"] = bf.num_bits
    on_tail = sk.contig_idx == 2
    info["minimizers"] = int(sk.n_minimizers)
    info["tail_minimizers"] = int(on_tail.sum())
    if info["tail_minimizers"] == 0:
        raise AssertionError("gigabase c: no minimizer on the tail contig")

    t0 = time.perf_counter()
    tail = packed_genome("T", g_codes[int(g.offsets[2]):], [TAIL_BP])
    host_bf = bloom.BloomFilter(bf.num_bits, k, words=bf.words.cpu())
    ref = sketch_ops.sketch_genome(tail, k, w, common_bf=host_bf, device="cpu")
    del host_bf
    info["cpu_tail_s"] = round(time.perf_counter() - t0, 3)
    for field in ("positions", "hashes"):
        got, want = getattr(sk, field)[on_tail], getattr(ref, field)
        if got.shape != want.shape or not np.array_equal(got, want):
            raise AssertionError(f"gigabase c: the card's tail {field} differ from the CPU's "
                                 f"({len(got)} vs {len(want)} minimizers)")
    info["tail_equal_cpu"] = True

    t0 = time.perf_counter()
    skm, info["mesh_launches"], _ = drive_path(torch, "sketch", lambda: pmesh.sharded_sketch_genome(
        g, k, w, mesh=pmesh.make_mesh(device=dev), common_bf=bf))
    info["mesh_s"] = round(time.perf_counter() - t0, 3)
    for field in ("contig_idx", "positions", "hashes"):
        if not np.array_equal(getattr(skm, field), getattr(sk, field)):
            raise AssertionError(f"gigabase d: the D = 1 mesh sketch's {field} differ from "
                                 "the single-device sketch's")
    info["mesh_d1_equal_single"] = True
    del bf, sk, skm, g, g_codes
    torch.cuda.empty_cache()


def phase_gigabase(torch, dev, tmp: str, info: dict, kernels: dict) -> None:
    """Checks a-d (module docstring, phase 14)."""
    giga = os.path.join(tmp, "giga")
    os.makedirs(giga)
    info["disk_free_bytes_at_start"] = shutil.disk_usage(giga).free
    t0 = time.perf_counter()
    paths = _gen_genomes(giga, GIGA_GENOMES, GIGA_BP)
    info["generate_write_s"] = round(time.perf_counter() - t0, 3)
    info["fasta_bytes"] = [os.path.getsize(p) for p in paths]

    # a: the default CLI, a process of its own
    work = os.path.join(giga, "cli")
    os.makedirs(work)
    a = info["a_cli"] = {}
    t0 = time.perf_counter()
    res = run_cli_worker(work, [*paths, "-d", "1", "-p", "smoke", "--benchmark"], timeout=600)
    a["process_s"] = round(time.perf_counter() - t0, 3)
    rows = shape_run_info(work, paths, res, a)
    num_bits = a["num_bits"]
    a["expected_launches"] = check_gigabase_launches(
        res["launches"], res["shapes"], GIGA_GENOMES, GIGA_BP, num_bits.bit_length() - 1)
    a["inversion_block"] = find_inversion(rows, GIGA_INV_START, GIGA_INV_START + GIGA_INV_BP,
                                          tol=GIGA_INV_TOL)
    a.update(sent_bytes(res["shapes"]))
    for name in kernels:
        kernels[name]["gigabase_launches"] = res["launches"][name]

    # b: the same genomes in this process, every stream released
    work_b = os.path.join(giga, "released")
    os.makedirs(work_b)
    b = info["b_release_forced"] = {}
    release_forced_run(torch, dev, work_b, paths, num_bits, b)
    b["stages"] = read_stages(os.path.join(work_b, "smoke.time.tsv"))
    with open(os.path.join(work, "smoke.synteny_blocks.tsv"), "rb") as f1, \
            open(os.path.join(work_b, "smoke.synteny_blocks.tsv"), "rb") as f2:
        if f1.read() != f2.read():
            raise AssertionError("gigabase b: the blocks differ from run a's")
    b["blocks_equal_a"] = True
    torch.cuda.empty_cache()
    info["peak_device_bytes"] = {"a": a["max_memory_allocated_bytes"],
                                 "b": b["max_memory_allocated_bytes"]}
    shutil.rmtree(giga, ignore_errors=True)

    # c, d: a stream past 2^31 bases, in memory
    past_2_31_checks(torch, dev, info.setdefault("c_d_past_2_31", {}))


# ---------------------------------------------------------------------------
# the published_shapes phase: the JAX package's other two published
# shapes through the CLI (bench.py --gbp 3 --genomes 2 and --gbp 0.1
# --genomes 11), and eleven genomes on the card against the CPU
# ---------------------------------------------------------------------------

HUMAN_BP = 3_000_000_000
HUMAN_GENOMES = 2
HUMAN_INV_START = int(HUMAN_BP * 0.4)
HUMAN_INV_BP = HUMAN_BP // 2000  # 1.5 Mbp
HUMAN_INV_TOL = 150_000  # GIGA_INV_TOL scaled from 500 kb to 1.5 Mbp
CAP_LOG2 = 34  # the common filter's cap (ops/bloom.pow2_bits)
# the JAX package's cascade occupancy per level at 2 x 3 Gbp (BENCH.md,
# round 5): the same genomes must fill the same bits
JAX_HUMAN_OCCUPANCY = (0.1602, 0.1568)
SLICE_START = 2_200_000_000  # a slice of genome A's one contig past 2^31
SLICE_BP = 4_000_000
# MemTotal a 2 x 3 Gbp run needs: the CLI process peaks at about 26 GB
# of host RSS, the generator holds about 12 GB before it
HUMAN_MIN_MEM = 48 << 30
# the CLI's device peak at 2 x 3 Gbp with the unpacked upload (2.0 bytes a
# base held: codes and a bool legit mask), measured on one NVIDIA H100
# 80GB HBM3 at 700 W; the packed stream must beat it
UNPACKED_HUMAN_PEAK = 18_581_000_000
HUMAN_MIN_DISK = 8 << 30  # two 3 Gbp FASTAs, their sketch TSVs and .fai
BEE_BP = 100_000_000
BEE_GENOMES = 11
BEE_INV_START = int(BEE_BP * 0.4)
BEE_INV_BP = BEE_BP // 2000  # 50 kb
BEE_LOG2 = 32
BEE_SMALL_BP = 1_000_000  # check c: eleven genomes, card against CPU
OCCUPANCY_LINE = re.compile(r"(?:Level-1 BF|Cascade BF) occupancy/FPR(?: after \S+)?: ([0-9.]+)")


def shape_run_info(work: str, paths, res: dict, info: dict) -> list:
    """Stage seconds, peaks, occupancy and the filter's size of a CLI
    worker run on bench.py's genomes; returns its block rows, which name
    every genome."""
    info.update(max_memory_allocated_bytes=res["max_memory_allocated_bytes"],
                launches=res["launches"], occupancy=res["occupancy"])
    for kernel in PATH_KERNELS["main"]:
        if res["launches"][kernel] <= 0:
            raise AssertionError(f"kernel {kernel} was not launched")
    with open(os.path.join(work, "smoke.common.bf")) as fin:
        info["num_bits"] = json.load(fin)["num_bits"]  # the stub's header
    if len(info["occupancy"]) != len(paths):
        raise AssertionError(f"{len(info['occupancy'])} cascade levels logged, "
                             f"want {len(paths)}")
    info["stages"] = read_stages(os.path.join(work, "smoke.time.tsv"))
    # the run's host RSS high-water as its stage timer sampled it
    info["peak_rss_mb"] = max(st["peak_rss_mb"] for st in info["stages"].values())
    rows = read_blocks(os.path.join(work, "smoke.synteny_blocks.tsv"))
    info["block_rows"] = len(rows)
    info["blocks"] = len({r["id"] for r in rows})
    names = sorted(os.path.basename(p) for p in paths)
    if sorted({r["asm"] for r in rows}) != names:
        raise AssertionError(f"the blocks name {sorted({r['asm'] for r in rows})}, want {names}")
    return rows


def human_shape(torch, dev, tmp: str, info: dict) -> dict:
    """Check a: bench.py's 2 x 3 Gbp genomes (one 3 Gbp contig each)
    through the CLI in a process of its own. The common filter over the
    same genomes is built in this process first; a CPU copy of its words
    probes the CPU port's sketch of a 4 Mbp slice of genome A past 2^31,
    which must equal the CLI's minimizers there. Returns the launches."""
    from ntsynt_tpu_torch.io.sketch_tsv import read_sketch_tsv
    from ntsynt_tpu_torch.ops import bf_build, bloom
    from ntsynt_tpu_torch.ops import sketch as sketch_ops

    k, w = 24, 1000
    human = os.path.join(tmp, "human")
    os.makedirs(human)
    info["mem_total_bytes"] = mem_total_bytes()
    info["disk_free_bytes_at_start"] = shutil.disk_usage(human).free
    if info["mem_total_bytes"] < HUMAN_MIN_MEM:
        raise AssertionError(f"2 x 3 Gbp: MemTotal is {info['mem_total_bytes']} bytes, below "
                             f"the {HUMAN_MIN_MEM} the run needs")
    if info["disk_free_bytes_at_start"] < HUMAN_MIN_DISK:
        raise AssertionError(f"2 x 3 Gbp: {info['disk_free_bytes_at_start']} bytes free on "
                             f"{human}, below the {HUMAN_MIN_DISK} the run needs")
    t0 = time.perf_counter()
    paths, codes = _gen_genomes(human, HUMAN_GENOMES, HUMAN_BP, keep=True)
    info["generate_write_s"] = round(time.perf_counter() - t0, 3)

    # the final filter's words on the host, and genome A's slice
    t0 = time.perf_counter()
    genomes = [packed_genome(os.path.basename(p), c, [HUMAN_BP]) for p, c in zip(paths, codes)]
    info["upload"] = time_upload(torch, dev, genomes[0], k, w)
    bf = bf_build.build_common_bf(genomes, k, device=dev)
    num_bits = bf.num_bits
    popcount = bf.popcount()
    host_bf = bloom.BloomFilter(num_bits, k, words=bf.words.cpu())
    slice_codes = codes[0][SLICE_START:SLICE_START + SLICE_BP].copy()
    del bf, genomes, codes
    torch.cuda.empty_cache()
    info["in_process_cascade_s"] = round(time.perf_counter() - t0, 3)

    work = os.path.join(human, "cli")
    os.makedirs(work)
    t0 = time.perf_counter()
    res = run_cli_worker(work, [*paths, "-d", "1", "-p", "smoke", "--benchmark"], timeout=900)
    info["process_s"] = round(time.perf_counter() - t0, 3)
    rows = shape_run_info(work, paths, res, info)
    if info["num_bits"] != 1 << CAP_LOG2 or num_bits != 1 << CAP_LOG2:
        raise AssertionError(f"2 x 3 Gbp: the filter has {info['num_bits']} bits "
                             f"({num_bits} in process), want the cap 2^{CAP_LOG2}")
    info["jax_occupancy"] = JAX_HUMAN_OCCUPANCY
    info["final_occupancy_in_process"] = popcount / num_bits
    if abs(popcount / num_bits - info["occupancy"][-1]) > 1e-4:
        raise AssertionError(f"2 x 3 Gbp: the in-process filter's occupancy {popcount / num_bits}"
                             f" is not the CLI's {info['occupancy'][-1]}")
    if info["blocks"] != 3 or len(rows) != 3 * HUMAN_GENOMES:
        raise AssertionError(f"2 x 3 Gbp: {info['blocks']} blocks in {len(rows)} rows, want 3 in "
                             f"{3 * HUMAN_GENOMES}: {rows}")
    info["inversion_block"] = find_inversion(rows, HUMAN_INV_START,
                                             HUMAN_INV_START + HUMAN_INV_BP, tol=HUMAN_INV_TOL)
    info["last_end"] = {a: max(r["end"] for r in rows if r["asm"] == a)
                        for a in sorted({r["asm"] for r in rows})}
    if min(info["last_end"].values()) <= TAIL_PAST:
        raise AssertionError(f"2 x 3 Gbp: a last block ends at or before 2^31: {info['last_end']}")
    info["expected_launches"] = check_gigabase_launches(
        res["launches"], res["shapes"], HUMAN_GENOMES, HUMAN_BP, CAP_LOG2, label="2 x 3 Gbp")
    info.update(sent_bytes(res["shapes"]))
    if info["max_memory_allocated_bytes"] >= UNPACKED_HUMAN_PEAK:
        raise AssertionError(f"2 x 3 Gbp: the device peak {info['max_memory_allocated_bytes']} "
                             f"is not below the unpacked stream's {UNPACKED_HUMAN_PEAK}")

    # the CLI's minimizers in the slice against the CPU port's sketch of
    # the slice alone, away from its edges
    t0 = time.perf_counter()
    edge = w + k
    ref = sketch_ops.sketch_genome(packed_genome("S", slice_codes, [SLICE_BP]), k, w,
                                   common_bf=host_bf, device="cpu")
    inner = (ref.positions >= edge) & (ref.positions < SLICE_BP - edge)
    (_, hashes, positions, _), = read_sketch_tsv(os.path.join(work, "benchA.fa.k24.w1000.tsv"))
    on = (positions >= SLICE_START + edge) & (positions < SLICE_START + SLICE_BP - edge)
    got_pos, got_h = positions[on], hashes[on]
    if len(got_pos) == 0 or not (np.array_equal(got_pos, ref.positions[inner] + SLICE_START)
            and np.array_equal(got_h, ref.hashes[inner])):
        raise AssertionError(f"2 x 3 Gbp: the CLI's {len(got_pos)} minimizers in [{SLICE_START}, "
                             f"+{SLICE_BP}) differ from the CPU port's {int(inner.sum())}")
    info["slice"] = dict(start=SLICE_START, bases=SLICE_BP, minimizers=len(got_pos),
                         equal_cpu=True, check_s=round(time.perf_counter() - t0, 3))
    del host_bf
    shutil.rmtree(human, ignore_errors=True)
    return res["launches"]


def bee_shape(tmp: str, info: dict) -> dict:
    """Check b: bench.py's 11 x 100 Mbp genomes through the CLI in a
    process of its own: 3 blocks, each one row for every genome and one
    minimizer count, the inversion found, 11 cascade levels on a 2^32-bit
    filter. Returns the launches."""
    bee = os.path.join(tmp, "bee")
    os.makedirs(bee)
    t0 = time.perf_counter()
    paths = _gen_genomes(bee, BEE_GENOMES, BEE_BP)
    info["generate_write_s"] = round(time.perf_counter() - t0, 3)
    work = os.path.join(bee, "cli")
    os.makedirs(work)
    t0 = time.perf_counter()
    res = run_cli_worker(work, [*paths, "-d", "1", "-p", "smoke", "--benchmark"], timeout=600)
    info["process_s"] = round(time.perf_counter() - t0, 3)
    rows = shape_run_info(work, paths, res, info)
    if info["num_bits"] != 1 << BEE_LOG2:
        raise AssertionError(f"11 x 100 Mbp: the filter has {info['num_bits']} bits, "
                             f"want 2^{BEE_LOG2}")
    ids = sorted({r["id"] for r in rows})
    if len(ids) != 3 or len(rows) != 3 * BEE_GENOMES:
        raise AssertionError(f"11 x 100 Mbp: {len(ids)} blocks in {len(rows)} rows, want 3 in "
                             f"{3 * BEE_GENOMES}")
    for i in ids:
        blk = [r for r in rows if r["id"] == i]
        if len({r["asm"] for r in blk}) != BEE_GENOMES or len({r["nmx"] for r in blk}) != 1:
            raise AssertionError(f"11 x 100 Mbp: block {i} is not one row a genome with one "
                                 f"minimizer count: {blk}")
    info["inversion_block"] = find_inversion(rows, BEE_INV_START, BEE_INV_START + BEE_INV_BP)
    info["expected_launches"] = check_gigabase_launches(
        res["launches"], res["shapes"], BEE_GENOMES, BEE_BP, BEE_LOG2, label="11 x 100 Mbp")
    info.update(sent_bytes(res["shapes"]))
    shutil.rmtree(bee, ignore_errors=True)
    return res["launches"]


def bee_card_vs_cpu(torch, tmp: str, info: dict) -> None:
    """Check c: the 11-genome shape at 11 x 1 Mbp through the CLI on
    --device cuda and --device cpu: every artifact byte-identical."""
    small = os.path.join(tmp, "bee_small")
    os.makedirs(small)
    paths = _gen_genomes(small, BEE_GENOMES, BEE_SMALL_BP)
    info.update(cli_card_vs_cpu(torch, small, "bee", [*paths, "-d", "1", "-p", "smoke"]))
    shutil.rmtree(small, ignore_errors=True)


def phase_published_shapes(torch, dev, tmp: str, info: dict, kernels: dict) -> None:
    """Checks a-c (module docstring, phase 15)."""
    launches = {"2x3gbp": human_shape(torch, dev, tmp, info.setdefault("a_2x3gbp", {}))}
    launches["11x100mbp"] = bee_shape(tmp, info.setdefault("b_11x100mbp", {}))
    bee_card_vs_cpu(torch, tmp, info.setdefault("c_11x1mbp_card_vs_cpu", {}))
    for name in kernels:
        kernels[name]["published_launches"] = {s: n[name] for s, n in launches.items()}


def main_cards(gigabase: bool = False) -> int:
    """``python3 chip_smoke.py --mesh-cards``, on a machine with several
    cards: the mesh path under NCCL, one rank per visible card, on the
    2 x 100 Mbp pair, default and --filter Indexlr (held to
    walk_at_mesh_segment's blocks), against the single-device CLI on card
    0, and the default run again in its directories (rank 0 reuses its
    sketch TSVs); then the collectives at as many ranks. With
    ``--gigabase``, instead: the default mesh run on the gigabase phase's
    3 x 1 Gbp genomes against the single-device CLI in a process of its
    own, with each rank's peak device memory."""
    here = os.path.dirname(os.path.abspath(__file__))
    import torch

    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < 2:
        print(f"chip_smoke.py --mesh-cards: needs two CUDA cards or more, found {n}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, here)
    from ntsynt_tpu_torch.ops import _kernels

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout
    emit({"phase": "device", "nvidia_smi": smi.strip().splitlines(), "count": n,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    _kernels.build()
    _kernels.build_host()
    tmp = tempfile.mkdtemp(prefix="ntsynt_cards_")
    try:
        if gigabase:
            with phase(f"mesh_nccl_{n}_gigabase", {}) as info:
                mesh_cards_gigabase(tmp, n, info)
            return finish_cards(smi, torch, n)
        fa, fb = make_pair(tmp, GENOME_BP, INV_START, INV_BP, 0.001, SEED)
        for name, extra in (("default", []), ("indexlr", ["--filter", "Indexlr"])):
            with phase(f"mesh_nccl_{n}_{name}", {}) as info:
                t0 = time.perf_counter()
                if extra:
                    single = walk_at_mesh_segment(torch, torch.device("cuda", 0), tmp,
                                                  f"single_{name}", [fa, fb])
                else:
                    work = os.path.join(tmp, f"single_{name}")
                    os.makedirs(work)
                    single = run_cli(work, [fa, fb, "-d", "1", "-p", "smoke"])
                info["single_device_cli_s"] = round(time.perf_counter() - t0, 3)
                results, dirs, wall = multihost_run(tmp, f"mesh_{name}", n, [fa, fb, *extra])
                info["processes_s"] = wall
                for r, (_, out) in enumerate(results):
                    if "(cuda, nccl)" not in out:
                        raise AssertionError(f"rank {r} is not a cuda/nccl rank:\n{out[-3000:]}")
                check_ranks(f"nccl_{n}_{name}", results, dirs, single, info)
                if not extra:
                    info["rerun"] = {}
                    rerun_ranks(tmp, f"mesh_{name}", n, [fa, fb], single, info["rerun"])
        with phase(f"collectives_nccl_{n}", {}) as info:
            run_collectives(tmp, n, "nccl", fa, fb, info)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return finish_cards(smi, torch, n)


def finish_cards(smi: str, torch, n: int) -> int:
    print(smi.strip().splitlines()[0], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": n}})
    return 0


def mesh_cards_gigabase(tmp: str, n: int, info: dict) -> None:
    """The default mesh run, one NCCL rank per card, on the 3 x 1 Gbp
    genomes: rank 0 writes the single-device CLI's blocks, the other
    ranks nothing; each rank's peak device memory and launches."""
    t0 = time.perf_counter()
    paths = _gen_genomes(tmp, GIGA_GENOMES, GIGA_BP)
    info["generate_write_s"] = round(time.perf_counter() - t0, 3)
    work = os.path.join(tmp, "single")
    os.makedirs(work)
    t0 = time.perf_counter()
    res = run_cli_worker(work, [*paths, "-d", "1", "-p", "smoke", "--benchmark"], timeout=600)
    info["single_device_process_s"] = round(time.perf_counter() - t0, 3)
    info["single_device_max_memory_allocated_bytes"] = res["max_memory_allocated_bytes"]
    info["single_device_stages"] = read_stages(os.path.join(work, "smoke.time.tsv"))
    results, dirs, wall = multihost_run(tmp, "mesh_gigabase", n, paths, timeout=900)
    info["processes_s"] = wall
    check_ranks(f"nccl_{n}_gigabase", results, dirs, os.path.join(work, "smoke.synteny_blocks.tsv"),
                info)


def main() -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isfile(os.path.join(here, "ntsynt_tpu_torch", "__init__.py")):
        print("chip_smoke.py: ntsynt_tpu_torch/ not found beside this script", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: torch.cuda.is_available() is False; needs one CUDA card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, here)
    from ntsynt_tpu_torch.ops import _kernels

    t_all = time.perf_counter()
    dev = torch.device("cuda", 0)
    with phase("device", {}) as info:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip().splitlines()[0]
        info.update(torch_name=torch.cuda.get_device_name(0), nvidia_smi=smi,
                    torch=torch.__version__, cuda=torch.version.cuda)

    with phase("build", {}) as info:
        _kernels.build()
        info.update(_kernels.BUILD_INFO)
        _kernels.lib()

    with phase("host_build", {}) as info:
        info["library"] = os.path.relpath(_kernels.build_host(), here)
        info.update(_kernels.HOST_BUILD_INFO)
        _kernels.host_lib()
        with open("/proc/self/maps") as fin:
            info["libgomp"] = sorted(set(re.findall(r"/\S*libgomp\S*", fin.read())))

    sources = {"nthash": "nthash.cu", "winmin": "winmin.cu", "compact": "compact.cu",
               "bf_insert": "bf_insert.cu", "bf_sweep": "bf_sweep.cu", "unpack": "unpack.cu"}
    replaces = {
        "nthash": "ntsynt_tpu/ops/nthash_pallas.py:74",
        "winmin": "ntsynt_tpu/ops/winmin_pallas.py:91",
        "compact": "ntsynt_tpu/ops/sketch_device.py:170",
        "bf_insert": "ntsynt_tpu/ops/bf_place.py:288",
        "bf_sweep": "ntsynt_tpu/ops/bf_sweep.py:221",
        # an XLA op of the JAX package, not a Pallas kernel: _unpack_stream_fn
        # (ntsynt_tpu/parallel/mesh.py:103, _unpack_row, is the mesh's copy)
        "unpack": "ntsynt_tpu/ops/sketch.py:381",
    }
    kernels = {
        name: dict(name=name, route="cuda", source=f"ntsynt_tpu_torch/csrc/{src}",
                   replaces=replaces[name], bound_by="bytes", library_ms=None)
        for name, src in sources.items()
    }
    with phase("kernels", {}) as info:
        phase_kernels(torch, dev, kernels)
        info["kernels"] = {n: {k: v for k, v in d.items() if k in
                               ("max_abs_err", "ms", "wrapper_ms", "plain_ms", "bound_ms",
                                "library_ms", "shape")}
                           for n, d in kernels.items()}

    tmp = tempfile.mkdtemp(prefix="ntsynt_smoke_")
    try:
        with phase("main_path", {}) as main_info:
            launches, shapes, fa, fb, main_out = phase_main_path(torch, tmp, main_info)
        with phase("winmin_refine", {}) as info:
            phase_winmin_refine(torch, dev, shapes, kernels, info)
        with phase("sweep_path", {}) as info:
            cascade, sweep_launches = phase_sweep_path(torch, dev, tmp, fa, fb, main_out, info)
        with phase("make_bf", {}) as info:
            phase_make_bf(torch, dev, tmp, fa, fb, cascade, info)
        del cascade
        torch.cuda.empty_cache()
        for mode in ("Indexlr", "Filter"):
            with phase(f"filter_{mode}", {}) as info:
                run_cli_path(torch, tmp, f"filter_{mode}", "filter",
                             [fa, fb, "--filter", mode], info)
        with phase("card_vs_cpu", {}) as info:
            phase_card_vs_cpu(torch, tmp, info)
        with phase("host_native", {}) as info:
            phase_host_native(tmp, fa, info)
        with phase("walk", {}) as info:
            phase_walk(torch, tmp, fa, fb, main_out, main_info, info)
        with phase("sidecars", {}) as info:
            phase_sidecars(tmp, main_out, info)
        with phase("mesh", {}) as info:
            phase_mesh(torch, dev, tmp, fa, fb, main_out, info, kernels)
        with phase("gigabase", {}) as info:
            phase_gigabase(torch, dev, tmp, info, kernels)
        with phase("published_shapes", {}) as info:
            phase_published_shapes(torch, dev, tmp, info, kernels)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    for name, d in kernels.items():
        # each kernel's launches on its own path: K5 on the sweep path
        # (NTSYNT_BF_SWEEP=1), the others on the default main path
        d["path"] = "sweep" if name == "bf_sweep" else "main"
        d["launches"] = (sweep_launches if name == "bf_sweep" else launches)[name]
        d["status"] = "ok"
    emit({"kernels": [kernels[n] for n in sources]})
    emit({"total_seconds": round(time.perf_counter() - t_all, 3)})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-worker"]:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        rank, world, port = (int(a) for a in sys.argv[2:5])
        sys.exit(mesh_worker(rank, world, port, *sys.argv[5:9]))
    if sys.argv[1:2] == ["--cli-worker"] and sys.argv[3:4] == ["--"]:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        sys.exit(cli_worker(sys.argv[2], sys.argv[4:]))
    if sys.argv[1:2] == ["--mesh-cards"] and sys.argv[2:] in ([], ["--gigabase"]):
        sys.exit(main_cards(gigabase=sys.argv[2:] == ["--gigabase"]))
    sys.exit(main())
