#!/usr/bin/env python3
"""Drive ntsynt_tpu_torch on one CUDA card and check it end to end.

    python3 chip_smoke.py

Phases, each printing one JSON line with its elapsed seconds:
  1. device: torch's device name and nvidia-smi's name and power limit;
  2. build: one nvcc call compiles ntsynt_tpu_torch/csrc/*.cu (cached in
     ntsynt_tpu_torch/_build/ by source hash);
  3. kernels: each CUDA kernel against its plain PyTorch version on the
     same inputs (made from a seed), at the shapes the main path gives
     it; outputs must be bit-identical (max_abs_err 0);
  4. main path: two 100 Mbp genomes (0.1% SNPs, one 50 kb inversion) are
     generated into a temporary directory and run through the port's CLI
     (``python -m ntsynt_tpu_torch a.fa b.fa -d 1``) on the card; the
     blocks TSV must hold the inversion as a '-' block and every kernel
     must have launched; prints each launch's sizes and the run's peak
     device memory;
  5. winmin_refine: the window-argmin kernel against its plain version at
     the key counts the main path's refinement rounds gave it;
  6. card vs CPU: a 200 kb two-genome scenario through the CLI on
     --device cuda and --device cpu; every artifact must be
     byte-identical.
Then the kernel table as one JSON line, nvidia-smi's "name, power limit"
line, and last {"ok": true, "device": {...}}. Any failed check raises,
so the script exits non-zero; without CUDA, or without the package
beside it, it exits non-zero before printing any result.
"""

import contextlib
import json
import os
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


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


@contextlib.contextmanager
def phase(name: str, info: dict):
    t0 = time.perf_counter()
    yield info
    emit({"phase": name, "seconds": round(time.perf_counter() - t0, 3), **info})


def cuda_time_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of fn on the card (CUDA events, after
    one warm-up call)."""
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


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def time_winmin(winmin, keys, w: int) -> dict:
    """K2 vs its plain version on keys at window w: check and time."""
    arg, minv = winmin.window_argmin(keys, w)
    parg, pminv = winmin.window_argmin_plain(keys, w)
    err = require_equal(f"K2 w={w}", [(arg, parg), (minv, pminv)])
    m = keys.shape[0]
    return dict(
        max_abs_err=err,
        ms=cuda_time_ms(lambda: winmin.window_argmin(keys, w), 5),
        plain_ms=cuda_time_ms(lambda: winmin.window_argmin_plain(keys, w), 1),
        bound_ms=(8 * m + 16 * (m - w + 1)) / HBM_BYTES_PER_S * 1e3,
        shape=f"{m} keys, w={w}",
    )


def phase_kernels(torch, dev, kernels: dict) -> None:
    """Each kernel vs its plain version at main-path shapes."""
    from ntsynt_tpu_torch.ops import _kernels, bf_build, bloom, nthash, sketch_device, winmin

    rng = np.random.default_rng(SEED)
    k = 24
    n = bf_build.SEG_KMERS  # the main path's segment: 2^26 k-mers / windows
    codes_np = rng.integers(0, 4, n + k - 1, dtype=np.uint8)
    codes_np[rng.random(n + k - 1) < 0.001] = 4  # N runs of one base
    codes = torch.from_numpy(codes_np).to(dev)

    # K1
    key, canon, valid = nthash.hash_kmers(codes, k, n)
    pk, pc, pv = nthash.hash_kmers_plain(codes, k, n)
    err = require_equal("K1", [(key, pk), (canon, pc), (valid, pv)])
    kernels["nthash"].update(
        max_abs_err=err,
        ms=cuda_time_ms(lambda: nthash.hash_kmers(codes, k, n), 10),
        plain_ms=cuda_time_ms(lambda: nthash.hash_kmers_plain(codes, k, n), 2),
        bound_ms=(n + k - 1 + 17 * n) / HBM_BYTES_PER_S * 1e3,
        shape=f"{n} k-mers, k={k}",
    )
    del pk, pc, pv

    # K2 at the main path's w; the refinement rounds' shapes are timed
    # after the main path has recorded them (phase_winmin_refine)
    k2 = time_winmin(winmin, key, 1000)
    arg_main, minv_main = winmin.window_argmin(key, 1000)
    # ties: few distinct keys, so runs of equal minima across windows
    tie_np = (rng.integers(0, 5, 1 << 20, dtype=np.int64) << 60).astype(np.int64)
    tie_np[rng.random(1 << 20) < 0.3] = -1
    ties = torch.from_numpy(tie_np).to(dev)
    for w in (1000, 100, 37, 10, 1):
        require_equal(f"K2 ties w={w}", zip(winmin.window_argmin(ties, w),
                                            winmin.window_argmin_plain(ties, w)))
    kernels["winmin"].update(k2, by_w={"1000": k2})

    # K3 on K2's output, with contig gaps in the legit mask
    nw = arg_main.shape[0]
    legit_np = np.ones(nw, dtype=bool)
    for s in rng.integers(0, nw - 2000, 64):
        legit_np[s : s + 1000 + k] = False
    legit = torch.from_numpy(legit_np).to(dev)
    pos, hsh = sketch_device.compact_minimizers(arg_main, minv_main, legit)
    ppos, phsh = sketch_device.compact_plain(arg_main, minv_main, legit)
    err = require_equal("K3", [(pos, ppos), (hsh, phsh)])
    if pos.shape[0] == 0 or bool((pos[1:] <= pos[:-1]).any()):
        raise AssertionError("K3: selections must be non-empty and strictly increasing")
    kernels["compact"].update(
        max_abs_err=err,
        ms=cuda_time_ms(lambda: sketch_device.compact_minimizers(arg_main, minv_main, legit), 10),
        plain_ms=cuda_time_ms(lambda: sketch_device.compact_plain(arg_main, minv_main, legit), 2),
        bound_ms=(17 * nw + 16 * pos.shape[0]) / HBM_BYTES_PER_S * 1e3,
        shape=f"{nw} windows -> {pos.shape[0]} minimizers",
    )

    # K4 into a 2^32-bit filter, the main path's size at 100 Mbp
    bits = 32
    nwords = (1 << bits) // 32
    words = torch.zeros(nwords, dtype=torch.int32, device=dev)
    bloom.insert_words(words, canon, valid, bits)
    pwords = bloom.insert_words_plain(torch.zeros_like(words), canon, valid, bits)
    err = require_equal("K4", [(words, pwords)])
    del pwords
    # 33- and 34-bit filters take canon's high bits into the word index
    w34 = torch.zeros((1 << 34) // 32, dtype=torch.int32, device=dev)
    sub = slice(0, 1 << 22)
    bloom.insert_words(w34, canon[sub].contiguous(), valid[sub].contiguous(), 34)
    p34 = bloom.insert_words_plain(torch.zeros_like(w34), canon[sub], valid[sub], 34)
    require_equal("K4 34-bit", [(w34, p34)])
    del w34, p34
    # only the words that valid keys hit must be read and written
    hit_words = torch.unique(bloom.bit_index(canon[valid], bits)[0]).numel()
    kernels["bf_insert"].update(
        max_abs_err=err,
        ms=cuda_time_ms(lambda: bloom.insert_words(words, canon, valid, bits), 10),
        plain_ms=cuda_time_ms(lambda: bloom.insert_words_plain(words, canon, valid, bits), 2),
        bound_ms=(9 * n + 8 * hit_words) / HBM_BYTES_PER_S * 1e3,
        shape=f"{n} keys into 2^{bits} bits ({hit_words} distinct words hit)",
    )
    del words, key, canon, valid, codes
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    _kernels.reset_launches()


def phase_main_path(torch, tmp: str, info: dict) -> dict:
    from ntsynt_tpu_torch.ops import _kernels

    inv_start = int(GENOME_BP * 0.4)
    t0 = time.perf_counter()
    fa, fb = make_pair(tmp, GENOME_BP, inv_start, INV_BP, 0.001, SEED)
    info["generate_s"] = round(time.perf_counter() - t0, 3)
    work = os.path.join(tmp, "main")
    os.makedirs(work)
    _kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = run_cli(work, [fa, fb, "-d", "1", "-p", "smoke", "--benchmark"])
    torch.cuda.synchronize()
    info["cli_s"] = round(time.perf_counter() - t0, 3)
    launches = dict(_kernels.LAUNCHES)
    info["launches"] = launches
    info["launch_shapes"] = {name: list(s) for name, s in _kernels.SHAPES.items()}
    # the run's peak: reset above, and nothing in the port resets it
    info["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated()
    stages = {}
    with open(os.path.join(work, "smoke.time.tsv")) as fin:
        next(fin)
        for line in fin:
            p = line.rstrip("\n").split("\t")
            stages[p[0]] = {"s": float(p[1]), "cuda_peak_so_far_mb": float(p[3])}
    info["stages"] = stages
    rows = read_blocks(out)
    info["blocks"] = len({r["id"] for r in rows})
    inv_end = inv_start + INV_BP
    hit = [r for r in rows if r["ori"] == "-" and abs(r["start"] - inv_start) < 5000
           and abs(r["end"] - inv_end) < 5000]
    if not hit:
        raise AssertionError(f"no '-' block covers the inversion [{inv_start}, {inv_end}): {rows}")
    info["inversion_block"] = {k: hit[0][k] for k in ("asm", "start", "end", "ori", "nmx")}
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"kernel {name} was not launched on the main path")
    return launches, info["launch_shapes"]


def phase_winmin_refine(torch, dev, shapes, kernels: dict, info: dict) -> None:
    """K2 vs its plain version at the largest key count the main path
    gave it for each refinement w, on keys hashed from seeded codes; and
    w=10 (the last round of the -d < 1 preset) at the smallest of those
    counts."""
    from ntsynt_tpu_torch.ops import nthash, winmin

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
    for w, n in sorted(largest.items(), reverse=True):
        codes = torch.from_numpy(rng.integers(0, 4, n + k - 1, dtype=np.uint8)).to(dev)
        keys = nthash.hash_kmers(codes, k, n)[0]
        by_w[str(w)] = time_winmin(winmin, keys, w)
        del codes, keys
    info["by_w"] = {w: by_w[str(w)] for w in sorted(largest, reverse=True)}


def phase_card_vs_cpu(tmp: str, info: dict) -> None:
    """The 200 kb inversion scenario of the CPU tests, on cuda and cpu."""
    rng = np.random.default_rng(1234)
    base = rng.integers(0, 4, 200_000).astype(np.uint8)
    inv = base.copy()
    inv[80_000:130_000] = inv[80_000:130_000][::-1] ^ 3
    small = os.path.join(tmp, "small")
    os.makedirs(small)
    fa = write_fasta(os.path.join(small, "ref.fa"), [("chr1", base)], width=70)
    fb = write_fasta(os.path.join(small, "inv.fa"), [("chr1", inv)], width=70)
    args = [fa, fb, "-d", "1", "-k", "24", "-w", "100", "--w_rounds", "50", "10",
            "-b", "500", "--indel", "500", "--merge", "3000", "-p", "smoke"]
    outs = {}
    for device in ("cuda", "cpu"):
        work = os.path.join(small, device)
        os.makedirs(work)
        run_cli(work, args + ["--device", device])
        outs[device] = {f: open(os.path.join(work, f), "rb").read() for f in sorted(os.listdir(work))}
    if sorted(outs["cuda"]) != sorted(outs["cpu"]):
        raise AssertionError(f"artifact sets differ: {sorted(outs['cuda'])} vs {sorted(outs['cpu'])}")
    for f in outs["cuda"]:
        if outs["cuda"][f] != outs["cpu"][f]:
            raise AssertionError(f"{f} differs between --device cuda and --device cpu")
    info["artifacts_identical"] = sorted(outs["cuda"])
    info["blocks_rows"] = outs["cuda"]["smoke.synteny_blocks.tsv"].decode().count("\n")


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

    sources = {"nthash": "nthash.cu", "winmin": "winmin.cu", "compact": "compact.cu",
               "bf_insert": "bf_insert.cu"}
    replaces = {
        "nthash": "ntsynt_tpu/ops/nthash_pallas.py:74",
        "winmin": "ntsynt_tpu/ops/winmin_pallas.py:91",
        "compact": "ntsynt_tpu/ops/sketch_device.py:170",
        "bf_insert": "ntsynt_tpu/ops/bf_place.py:288",
    }
    kernels = {
        name: dict(name=name, route="cuda", source=f"ntsynt_tpu_torch/csrc/{src}",
                   replaces=replaces[name], bound_by="bytes", library_ms=None)
        for name, src in sources.items()
    }
    with phase("kernels", {}) as info:
        phase_kernels(torch, dev, kernels)
        info["kernels"] = {n: {k: v for k, v in d.items() if k in
                               ("max_abs_err", "ms", "plain_ms", "bound_ms", "shape")}
                           for n, d in kernels.items()}

    tmp = tempfile.mkdtemp(prefix="ntsynt_smoke_")
    try:
        with phase("main_path", {}) as info:
            launches, shapes = phase_main_path(torch, tmp, info)
        with phase("winmin_refine", {}) as info:
            phase_winmin_refine(torch, dev, shapes, kernels, info)
        with phase("card_vs_cpu", {}) as info:
            phase_card_vs_cpu(tmp, info)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    for name, d in kernels.items():
        d["launches"] = launches[name]
        d["status"] = "ok"
    emit({"kernels": [kernels[n] for n in sources]})
    emit({"total_seconds": round(time.perf_counter() - t_all, 3)})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
