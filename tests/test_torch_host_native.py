"""The port's host library (csrc/host/*.cpp, built by
ops/_kernels.build_host with g++) against the NumPy paths and the JAX
package: the FASTA packer against the port's NumPy reader and both of
the JAX package's readers, the packed stream layout against its NumPy
form,
and the chain walker, native and with NTSYNT_NO_NATIVE_WALK, against
the JAX package's linear_paths. Also the build itself: two processes
building into one fresh directory, and a failing compiler."""

import ctypes
import gzip
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ntsynt_tpu.graph import MinimizerGraph as JaxGraph
from ntsynt_tpu.graph import mxgraph as jax_mxgraph
from ntsynt_tpu.io import fasta as jax_fio
from ntsynt_tpu.ops import sketch as jax_sketch
from ntsynt_tpu_torch.graph import mxgraph
from ntsynt_tpu_torch.graph.mxgraph import MinimizerGraph
from ntsynt_tpu_torch.io import fasta as fio
from ntsynt_tpu_torch.ops import _kernels, unpack
from ntsynt_tpu_torch.ops import sketch as torch_sketch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the eight edge cases of the two readers; the '>'-only header is the
# one where the JAX package's paths differ (the NumPy path raises
# IndexError, the native one names the contig '')
EDGE_CASES = {
    "text_before_header": b"stray text\nACGT\n>c1 x\nACGTN\nac\n>c2\nGG\n",
    "empty_contig": b">e1\n>c1\nACGTACGT\nAC\n>e2\n>c2\nTTTT\n>e3\n",
    "tab_in_header": b">c1\tsome desc\nACGT\nAC\n>c2 \tx\nGGGG\n",
    "crlf": b">c1 desc\r\nACGTAC\r\nACG\r\n>c2\r\nTTTT\r\n",
    "no_trailing_newline": b">c1\nACGTACGT\nACG\n>c2\nTTGCA",
    "blank_line_in_contig": b">c1\nACGTAC\n\nACGTAC\nAC\n\n>c2\n\nGGCC\n",
    "header_only_gt": b">\nACGTACGT\nAC\n>c2\nTTTT\n",
    "space_in_sequence": b">c1\nACGT ACGT\nAC GT\n>c2\nT T\n",
}
FIELDS = ("lengths", "offsets", "codes", "raw", "fai_offsets", "fai_linebases", "fai_linewidth")


def _jax_native_lib():
    """The JAX package's csrc/libfastaio.so, or None when it is absent or
    does not load on this host (built -march=native elsewhere)."""
    try:
        return jax_fio._native_lib()
    except OSError:
        return None


def _fai(g, path) -> bytes:
    return open(fio.write_fai(g, str(path)), "rb").read()


def _assert_same_genome(a, b, tmp_path):
    assert a.contig_names == b.contig_names
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape and (x == y).all(), f
    assert _fai(a, tmp_path / "a.fai") == _fai(b, tmp_path / "b.fai")


def _readers():
    """name -> reader(path, threads) for the port's two paths and the
    JAX package's two (its native one when its library loads)."""
    readers = {
        "torch_numpy": lambda p, t: fio.read_fasta(p, native=False),
        "jax_numpy": lambda p, t: jax_fio.read_fasta(p, native=False),
    }
    if _jax_native_lib() is not None:
        readers["jax_native"] = lambda p, t: jax_fio.read_fasta(p, native=True, threads=t)
    return readers


@pytest.mark.parametrize("case", sorted(EDGE_CASES))
def test_edge_cases_match_every_reader(tmp_path, case):
    path = tmp_path / f"{case}.fa"
    path.write_bytes(EDGE_CASES[case])
    g = fio.read_fasta(str(path), native=True)
    assert fio.read_fasta(str(path)).contig_names == g.contig_names  # native=None: native
    readers = _readers()
    if case == "header_only_gt":
        # per path, as the JAX package does it
        assert g.contig_names == ["", "c2"]
        for name in ("torch_numpy", "jax_numpy"):
            with pytest.raises(IndexError):
                readers.pop(name)(str(path), 0)
    for name, read in readers.items():
        _assert_same_genome(g, read(str(path), 0), tmp_path)


def _random_fasta(path, rng, contigs, width):
    dec = np.frombuffer(b"ACGTNacgtn", dtype=np.uint8)
    with open(path, "wb") as fout:
        for i, n in enumerate(contigs):
            raw = dec[rng.integers(0, 10, n)]
            lines = [raw[j : j + width].tobytes() for j in range(0, n, width)]
            fout.write(f">ctg{i} desc {i}\n".encode() + b"\n".join(lines) + b"\n")
    return str(path)


@pytest.mark.parametrize("shape", ["multi_contig", "2^22_bases"])
def test_random_files_match_every_reader(tmp_path, shape):
    rng = np.random.default_rng(7)
    contigs = [int(x) for x in rng.integers(1, 50_000, 12)] if shape == "multi_contig" \
        else [1 << 22]
    path = _random_fasta(tmp_path / "r.fa", rng, contigs, 61)
    g1 = fio.read_fasta(path, native=True, threads=1)
    g4 = fio.read_fasta(path, native=True, threads=4)
    _assert_same_genome(g1, g4, tmp_path)
    assert g1.total_bases == sum(contigs)
    for name, read in _readers().items():
        _assert_same_genome(g1, read(path, 4), tmp_path)


def test_keep_raw_false_and_fallbacks(tmp_path):
    """keep_raw=False drops raw on both paths; an empty file falls back to
    NumPy under native=None and raises under native=True; gzip takes the
    NumPy path."""
    path = _random_fasta(tmp_path / "r.fa", np.random.default_rng(1), [3000, 10], 70)
    g = fio.read_fasta(path, keep_raw=False)
    assert g.raw is None and fio.read_fasta(path, keep_raw=False, native=False).raw is None
    assert (g.codes == fio.read_fasta(path, native=False).codes).all()
    empty = tmp_path / "empty.fa"
    empty.write_bytes(b"")
    assert fio.read_fasta(str(empty)).n_contigs == 0
    assert jax_fio.read_fasta(str(empty)).n_contigs == 0
    with pytest.raises(IOError):
        fio.read_fasta(str(empty), native=True)
    gz = tmp_path / "r.fa.gz"
    with gzip.open(gz, "wb") as fout:
        fout.write(open(path, "rb").read())
    _assert_same_genome(fio.read_fasta(str(gz), native=True),
                        fio.read_fasta(path, native=True), tmp_path)


def test_read_restores_the_thread_count(tmp_path):
    """A read at threads=1 sets OpenMP's thread count only for its own
    duration: torch's CPU ops (one OpenMP runtime with the host library
    when both load the same libgomp.so.1) keep theirs."""
    path = _random_fasta(tmp_path / "r.fa", np.random.default_rng(2), [5000] * 3, 70)
    before = torch.get_num_threads()
    fio.read_fasta(path, threads=1)
    assert torch.get_num_threads() == before
    assert _kernels.host_lib().omp_get_max_threads() == before


def _stream_numpy(genome, src, starts, total):
    """The stream layout's NumPy form: the per-contig copy loop."""
    buf = np.full(total, 4, dtype=np.uint8)
    for i in range(genome.n_contigs):
        o, ln = int(genome.offsets[i]), int(genome.lengths[i])
        buf[starts[i] : starts[i] + ln] = src[o : o + ln]
    return buf


@pytest.mark.parametrize("masked", [False, True])
def test_stream_codes_native_equal_numpy_and_jax(tmp_path, monkeypatch, masked):
    rng = np.random.default_rng(3)
    path = _random_fasta(tmp_path / "s.fa", rng, [40_000, 7, 0, 12_345, 150], 60)
    tg = fio.read_fasta(path)
    jg = jax_fio.read_fasta(path, native=False)
    src = None
    if masked:  # refinement rounds stream masked copies of the codes
        src = tg.codes.copy()
        src[rng.random(len(src)) < 0.2] = 4
    k, w = 24, 100
    ts = torch_sketch._Stream(tg, k, w, codes=src)
    js = jax_sketch._Stream(jg, k, w, codes=src)
    # the native packer's stream, unpacked (padded with code 4 to a
    # multiple of 8), and as the grouped upload assembles it
    n8 = -(-ts.total // 8) * 8
    packed2, nbits = ts.pack(0, ts.total, n8)
    codes = unpack.unpack_plain(torch.from_numpy(packed2), torch.from_numpy(nbits)).numpy()
    assert codes.dtype == np.uint8 and len(codes) == n8 and (codes[ts.total:] == 4).all()
    codes = codes[: ts.total]
    assert (codes == _stream_numpy(tg, tg.codes if src is None else src, ts.starts,
                                   ts.total)).all()
    assert (codes == js.codes).all()
    monkeypatch.setattr(torch_sketch, "GROUP_KMERS", 4096)
    up = torch_sketch.PackedUpload(ts, "cpu")
    assert up.n_groups > 1 and (up.codes.numpy() == codes).all()


def test_build_stream_rejects_bad_layouts():
    """The stream packer (io/fasta.pack_stream, which lays the stream out
    as it packs) refuses overlapping or out-of-range contigs and a length
    that is not a multiple of 8."""
    codes = np.zeros(100, np.uint8)
    off, ln = np.array([0, 50]), np.array([50, 50])
    packed2, nbits = fio.pack_stream(codes, off, ln, np.array([0, 60]), 120)
    assert len(packed2) == 30 and len(nbits) == 15
    for starts, out_len in (([0, 40], 120), ([0, 60], 104), ([-1, 60], 120), ([0, 60], 116)):
        with pytest.raises(ValueError):
            fio.pack_stream(codes, off, ln, np.array(starts), out_len)
    with pytest.raises(ValueError):
        fio.pack_stream(codes, off, np.array([50, 51]), np.array([0, 60]), 200)
    with pytest.raises(ValueError):  # out of the wrong size
        fio.pack_stream(codes, off, ln, np.array([0, 60]), 120,
                        out=(np.empty(30, np.uint8), np.empty(14, np.uint8)))


def test_thread_flags_reach_the_reader(tmp_path, monkeypatch):
    """-t (the CLI, both make_bf CLIs) and --btllib_t (run_core) are the
    reader's thread count; the CLI's blocks are the same at 1 thread and
    at more threads than this host has cores."""
    from ntsynt_tpu_torch import cli, make_bf, run_core

    rng = np.random.default_rng(4)
    a = rng.integers(0, 4, 60_000).astype(np.uint8)
    b = a.copy()
    b[20_000:30_000] = b[20_000:30_000][::-1] ^ 3
    dec = np.frombuffer(b"ACGT", dtype=np.uint8)
    fastas = []
    for name, g in (("ta.fa", a), ("tb.fa", b)):
        body = b"".join(dec[g[i : i + 70]].tobytes() + b"\n" for i in range(0, len(g), 70))
        (tmp_path / name).write_bytes(b">c1\n" + body[: len(body) // 2] + b">c2\n"
                                      + body[len(body) // 2 :])
        fastas.append(str(tmp_path / name))
    seen = []
    real = fio.read_fasta

    def spy(path, *args, **kw):
        seen.append(kw.get("threads"))
        return real(path, *args, **kw)

    for mod in (fio, make_bf, run_core):
        monkeypatch.setattr(mod, "read_fasta", spy)
    monkeypatch.chdir(tmp_path)
    args = [*fastas, "-d", "1", "-w", "100", "--w_rounds", "50", "10", "--merge", "3000",
            "--device", "cpu"]
    blocks = []
    for t in (1, 4 * (os.cpu_count() or 1)):
        seen.clear()
        assert cli.main([*args, "-p", f"t{t}", "-t", str(t), "-f"]) == 0
        assert seen == [t, t]
        blocks.append((tmp_path / f"t{t}.synteny_blocks.tsv").read_bytes())
    assert blocks[0] == blocks[1] and blocks[0]
    seen.clear()
    assert make_bf.common_main(["--genome", *fastas, "-k", "24", "-p", "c", "-t", "3",
                                "--device", "cpu"]) == 0
    assert make_bf.repeat_main(["--genome", fastas[0], "-k", "24", "-p", "r", "-t", "2",
                                "--device", "cpu"]) == 0
    assert run_core.main(["ta.fa.k24.w100.tsv", "tb.fa.k24.w100.tsv", "--fastas", *fastas,
                          "-k", "24", "-w", "100", "--btllib_t", "5", "-p", "rc",
                          "--device", "cpu"]) == 0
    assert seen == [3, 3, 2, 5, 5]


# ---------------------------------------------------------------------------
# the chain walker
# ---------------------------------------------------------------------------


def _adjacency(case):
    """(adjacency per assembly, min weight, simplify) of the
    tests/test_graph.py graphs, plus a 200k-node chain."""
    rng = np.random.default_rng(5)
    if case == "chain":
        return [[[1, 2, 3, 4]], [[1, 2, 3, 4]]], 2, False
    if case == "two_components":
        return [[[1, 2, 3], [7, 8]], [[1, 2, 3], [7, 8]]], 2, False
    if case == "cycle":
        return [[[1, 2, 3, 1]]], 0, False
    if case == "branch":
        return [[[1, 2, 3], [4, 2]]], 0, False
    if case == "bubble":
        return [[[0, 1, 2, 3, 4]], [[0, 1, 3, 4]]], 2, True
    if case == "mixed":  # tests/test_graph.py::test_native_walker_matches_numpy
        return [[rng.permutation(np.arange(1, 2001)), [9001, 9002], [9003, 9004, 9005],
                 [7001, 7002, 7003, 7001], [8001, 8002, 8003], [8004, 8002, 8005]]], 0, False
    assert case == "chain_200k"
    return [[rng.permutation(np.arange(1, 200_001))]], 0, False


def _paths(cls, case):
    lists, min_w, simplify = _adjacency(case)
    adj = [(f"a{i}", [np.asarray(x, np.uint64) for x in ls]) for i, ls in enumerate(lists)]
    g = cls.build(adj, {name: 1 for name, _ in adj})
    if simplify:
        g = g.simplify_bubbles(2)
    if min_w:
        g = g.filter_global(min_w)
    return [p.tolist() for p in g.linear_paths()]


@pytest.mark.parametrize(
    "case", ["chain", "two_components", "cycle", "branch", "bubble", "mixed", "chain_200k"])
def test_walker_matches_numpy_and_jax(monkeypatch, case):
    monkeypatch.delenv("NTSYNT_NO_NATIVE_WALK", raising=False)
    assert mxgraph._walk_lib() is not None
    native = _paths(MinimizerGraph, case)
    jax_native = _paths(JaxGraph, case)
    monkeypatch.setenv("NTSYNT_NO_NATIVE_WALK", "1")
    assert mxgraph._walk_lib() is None
    jax_mxgraph._walk_lib.cache_clear()
    try:
        numpy = _paths(MinimizerGraph, case)
        jax_numpy = _paths(JaxGraph, case)
    finally:
        monkeypatch.delenv("NTSYNT_NO_NATIVE_WALK")
        jax_mxgraph._walk_lib.cache_clear()
    assert native == numpy == jax_numpy == jax_native
    if case in ("chain", "bubble", "chain_200k"):
        assert len(native) == 1
    if case in ("cycle", "branch"):
        assert native == []


# ---------------------------------------------------------------------------
# the build
# ---------------------------------------------------------------------------


def test_two_processes_build_into_one_fresh_directory(tmp_path):
    out = tmp_path / "build"
    code = ("import sys\nfrom ntsynt_tpu_torch.ops import _kernels\n"
            "print(_kernels.build_host(sys.argv[1]))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    procs = [subprocess.Popen([sys.executable, "-c", code, str(out)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    results = [p.communicate(timeout=300) for p in procs]
    for p, (stdout, stderr) in zip(procs, results):
        assert p.returncode == 0, stderr[-3000:]
        assert stdout.strip() == str(out / _kernels.HOST_LIB_NAME)
    assert sorted(os.listdir(out)) == [_kernels.HOST_LIB_NAME, _kernels.HOST_LIB_NAME + ".sha256"]
    lib = ctypes.CDLL(str(out / _kernels.HOST_LIB_NAME))
    assert lib.fastaio_parse and lib.graphwalk_chains
    # a third build finds the library for its digest and reuses it
    _kernels.build_host(str(out))
    assert _kernels.HOST_BUILD_INFO["cached"] is True


def test_failed_build_raises_with_compiler_output(tmp_path, monkeypatch):
    monkeypatch.setenv("CXX", "sh -c 'echo no-such-compiler-here >&2; exit 3' --")
    with pytest.raises(RuntimeError, match="no-such-compiler-here"):
        _kernels.build_host(str(tmp_path))
    assert not os.path.exists(tmp_path / _kernels.HOST_LIB_NAME)
