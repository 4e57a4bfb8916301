"""Gigabase paths of the port on the CPU.

* ``core.pipeline.release_plan``, the cascade's stream-release rule,
  against hand-worked cases.
* ``ops.bf_build.build_common_bf_from_device`` takes lazy entries: each
  genome's ``get`` is called when its level starts, ``release`` right
  after its level, and the filter equals the eager build's.
* A three-genome run whose plan releases every stream writes the same
  artifacts, byte for byte, as a run that releases none; released
  streams are built again at their sketches.
* Stream offsets past 2^31 and 2^32: ``_Stream.to_contig_pos``,
  ``finish_sketch``, and the mesh's slab bounds map positions exactly,
  on a genome stub whose lengths sum past 2^32 and whose codes are never
  touched. Tolerance 0 throughout.
"""

import os

import numpy as np
import pytest
import torch

from ntsynt_tpu_torch.core import pipeline as tpipe
from ntsynt_tpu_torch.core.pipeline import NtSyntPipeline, PipelineConfig, release_plan
from ntsynt_tpu_torch.io.fasta import read_fasta
from ntsynt_tpu_torch.ops import bf_build, nthash
from ntsynt_tpu_torch.ops import sketch as sketch_ops
from ntsynt_tpu_torch.parallel import mesh as pmesh

DEC = np.array(list("ACGT"))
GIB = 1 << 30
K, W = 24, 100


# ---------------------------------------------------------------------------
# release_plan
# ---------------------------------------------------------------------------

SIZES = {"a.fa": 600_000_000, "b.fa": 400_000_000, "c.fa": 1_000_000_000}
# two 2^33-bit levels (2 x 1 GiB) plus 1.125 bytes a file byte of each
# genome (STREAM_BYTES_PER_BASE: unpacked codes and legit bits)
RESIDENT = 2 * GIB + 2_250_000_000


@pytest.mark.parametrize("budget,released", [
    (RESIDENT + 1, set()),
    (RESIDENT, set()),  # exactly fits
    (RESIDENT - 1, {"a.fa", "c.fa"}),  # over: the genomes above 505 MB
    (0, {"a.fa", "c.fa"}),
])
def test_release_plan_hand_worked(budget, released):
    assert release_plan(SIZES, 1 << 33, budget) == released


def test_release_plan_line_and_levels():
    """The line is strict (505,000,000 bytes stays), and the levels count:
    the same streams fit beside 2^30-bit levels and not beside 2^34-bit."""
    sizes = {"x": 505_000_000, "y": 505_000_001}
    streams = 568_125_000 + 568_125_001  # int(1.125 * size) each
    assert release_plan(sizes, 1 << 30, streams + (1 << 28)) == set()
    assert release_plan(sizes, 1 << 34, streams + (1 << 28)) == {"y"}
    assert release_plan({"z": 1}, 1 << 34, 0) == set()  # over, but nothing above the line


def test_stream_budget_none_on_cpu():
    assert tpipe.stream_budget(torch.device("cpu")) is None


# ---------------------------------------------------------------------------
# the lazy cascade
# ---------------------------------------------------------------------------


def _write(path, contigs):
    with open(path, "w") as f:
        for name, codes in contigs:
            s = "".join(DEC[codes])
            f.write(f">{name}\n" + "\n".join(s[i : i + 70] for i in range(0, len(s), 70)) + "\n")
    return str(path)


@pytest.fixture(scope="module")
def trio(tmp_path_factory):
    """Three 50 kb genomes: a base, a copy with 0.1% SNPs and an
    inversion, and a copy with 0.1% SNPs in two contigs."""
    tmp = tmp_path_factory.mktemp("torch_gigabase")
    rng = np.random.default_rng(20260817)
    base = rng.integers(0, 4, 50_000).astype(np.uint8)
    copies = []
    for _ in range(2):
        c = base.copy()
        snp = rng.random(len(c)) < 0.001
        c[snp] = (c[snp] + rng.integers(1, 4, int(snp.sum()))) % 4
        copies.append(c)
    copies[0][20_000:30_000] = copies[0][20_000:30_000][::-1] ^ 3
    return [_write(tmp / "ga.fa", [("chr1", base)]),
            _write(tmp / "gb.fa", [("chr1", copies[0])]),
            _write(tmp / "gc.fa", [("chr1", copies[1][:31_000]), ("chr2", copies[1][31_000:])])]


def test_cascade_calls_get_at_its_level_and_release_after(trio):
    """get(i) runs when level i starts (after level i-1's insert),
    release(i) after level i; the filter equals the eager build's."""
    genomes = [read_fasta(p) for p in trio]
    events = []
    insert = bf_build.insert_stream

    def get(g):
        events.append(("get", g.name))
        return bf_build.kmer_stream(g, K, "cpu")

    def recording_insert(*a, **kw):
        events.append(("insert",))
        return insert(*a, **kw)

    bf_build.insert_stream = recording_insert
    try:
        bf = bf_build.build_common_bf_from_device(
            [(g.name, lambda g=g: get(g)) for g in genomes], K, 1 << 20, "cpu",
            release=lambda n: events.append(("release", n)))
    finally:
        bf_build.insert_stream = insert
    want = []
    for g in genomes:
        want += [("get", g.name), ("insert",), ("release", g.name)]
    assert events == want
    eager = bf_build.build_common_bf(genomes, K, bf_bytes=(1 << 20) // 8, device="cpu")
    assert torch.equal(bf.words, eager.words)


def _run(trio, out_dir, monkeypatch, release_all: bool):
    """One in-process run; returns ({file: bytes}, events): the
    DeviceStreams built and the levels inserted, in order, and the
    releases."""
    events = []
    stream_cls, insert = sketch_ops.DeviceStream, bf_build.insert_stream

    class RecordingStream(stream_cls):
        def __init__(self, genome, *a, **kw):
            events.append(("stream", genome.name))
            super().__init__(genome, *a, **kw)

    def recording_insert(*a, **kw):
        events.append(("insert",))
        return insert(*a, **kw)

    cascade = bf_build.build_common_bf_from_device

    def recording_cascade(*a, release=None, **kw):
        def rel(n):
            events.append(("release", n))
            release(n)
        return cascade(*a, release=rel if release else None, **kw)

    monkeypatch.setattr(sketch_ops, "DeviceStream", RecordingStream)
    monkeypatch.setattr(bf_build, "insert_stream", recording_insert)
    monkeypatch.setattr(bf_build, "build_common_bf_from_device", recording_cascade)
    if release_all:
        # a budget of 0 bytes under a line of 0 bytes: every stream goes
        monkeypatch.setattr(tpipe, "stream_budget", lambda device: 0)
        monkeypatch.setattr(tpipe, "RELEASE_LINE_BYTES", 0)
    os.makedirs(out_dir)
    NtSyntPipeline(PipelineConfig(
        fastas=trio, k=K, w=W, w_rounds=(50, 10), block_size=500, indel=500, merge="3000",
        prefix="gb", bf_artifact="full", out_dir=str(out_dir), device="cpu")).run()
    monkeypatch.undo()
    files = {f: open(os.path.join(out_dir, f), "rb").read() for f in sorted(os.listdir(out_dir))}
    return files, events


def test_release_every_stream_writes_same_artifacts(trio, tmp_path, monkeypatch):
    kept, kept_events = _run(trio, tmp_path / "kept", monkeypatch, release_all=False)
    freed, freed_events = _run(trio, tmp_path / "freed", monkeypatch, release_all=True)
    assert "gb.synteny_blocks.tsv" in kept and "gb.common.bf" in kept
    assert sorted(kept) == sorted(freed)
    for f in kept:
        assert kept[f] == freed[f], f"{f} differs"
    names = [os.path.basename(p) for p in trio]  # path order is name order here
    cascade, released = [], []
    for n in names:
        cascade += [("stream", n), ("insert",)]
        released += [("stream", n), ("insert",), ("release", n)]
    # no release: one stream a genome, each built when its level starts
    # and used by its sketch; the refinement rounds build their own
    assert kept_events[: len(cascade)] == cascade
    refine = kept_events[len(cascade):]
    assert refine and all(e[0] == "stream" for e in refine)
    # every stream released after its level and built again at its sketch
    assert freed_events == released + [("stream", n) for n in names] + refine


# ---------------------------------------------------------------------------
# offsets past 2^31 and 2^32
# ---------------------------------------------------------------------------


class _Untouchable:
    """Stands in for the codes of a genome too large to hold: any use
    fails the test."""

    def __getattr__(self, name):
        raise AssertionError(f"the codes were touched ({name})")

    def __getitem__(self, key):
        raise AssertionError("the codes were touched")

    def __len__(self):
        raise AssertionError("the codes were touched")


class _GenomeStub:
    """A PackedGenome's geometry, lengths summing past 2^32."""

    def __init__(self, lengths):
        self.name = "big.fa"
        self.lengths = np.asarray(lengths, dtype=np.int64)
        self.offsets = np.concatenate([[0], np.cumsum(self.lengths)[:-1]]).astype(np.int64)
        self.contig_names = [f"c{i}" for i in range(len(lengths))]
        self.codes = _Untouchable()

    @property
    def n_contigs(self):
        return len(self.lengths)


# contig 1 starts past 2^31, contig 2 past 2^32, contig 3 just after it
LENGTHS = [(1 << 31) + 7, (1 << 31) + 3, 4_000_000, 5_000]
SEP = W + K


def _starts(sep):
    return np.concatenate([[0], np.cumsum(np.asarray(LENGTHS) + sep)[:-1]]).astype(np.int64)


def test_stream_starts_and_contig_pos_past_2_32():
    stub = _GenomeStub(LENGTHS)
    st = sketch_ops._Stream(stub, K, W)
    starts = _starts(SEP)
    assert starts[1] > (1 << 31) and starts[2] > (1 << 32)
    np.testing.assert_array_equal(st.starts, starts)
    assert st.total == int(starts[-1]) + LENGTHS[-1] + SEP
    # every contig's first and last k-mer start, and places in between
    pos, ci, cp = [], [], []
    for i, ln in enumerate(LENGTHS):
        for off in (0, 1, ln // 2, ln - K):
            pos.append(int(starts[i]) + off)
            ci.append(i)
            cp.append(off)
    idx, cpos = st.to_contig_pos(np.asarray(pos, dtype=np.int64))
    assert idx.tolist() == ci
    assert cpos.dtype == np.int64 and cpos.tolist() == cp


def test_finish_sketch_past_2_32():
    """The host epilogue maps selections past 2^32 to their contigs;
    every contig has at least w k-mers, so no fallback reads the codes."""
    stub = _GenomeStub(LENGTHS)
    st = sketch_ops._Stream(stub, K, W)
    assert st.short_contigs() == []
    starts = _starts(SEP)
    rng = np.random.default_rng(5)
    want_ci = np.array([0, 0, 1, 1, 2, 2, 2, 3], dtype=np.int32)
    want_pos = np.array([0, LENGTHS[0] - K, 11, LENGTHS[1] - K, 0, 123_456, LENGTHS[2] - K, 17],
                        dtype=np.int64)
    sel = starts[want_ci] + want_pos
    selh = rng.integers(0, 1 << 63, len(sel), dtype=np.int64).view(np.uint64) | np.uint64(1)
    sk = sketch_ops.finish_sketch(stub, st, sel, selh, K, W)
    assert sk.contig_idx.tolist() == want_ci.tolist()
    assert sk.positions.tolist() == want_pos.tolist()
    np.testing.assert_array_equal(sk.hashes, selh)
    np.testing.assert_array_equal(sk.canon, nthash.unmix_np(selh, K))


@pytest.mark.parametrize("d", [1, 2, 3, 4])
def test_mesh_share_past_2_32(d):
    """The ranks' window shares tile [0, n) for n past 2^32, and a rank's
    local selections shifted by its lo map to the contig positions of
    the whole stream."""
    stub = _GenomeStub(LENGTHS)
    st = sketch_ops._Stream(stub, K, W)
    n = st.total - (W + K - 1) + 1
    shares = [pmesh.Mesh(None, r, d, torch.device("cpu")).share(n) for r in range(d)]
    assert shares[0][0] == 0 and shares[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(shares, shares[1:]))
    starts = _starts(SEP)
    lo, hi = shares[-1]
    # the last rank's share holds contigs 2 and 3, past 2^32
    local = np.array([starts[2] - lo, starts[2] - lo + 99, starts[3] - lo], dtype=np.int64)
    assert (local >= 0).all() and (local + lo < hi).all() or d == 1
    idx, cpos = st.to_contig_pos(local + lo)
    assert idx.tolist() == [2, 2, 3] and cpos.tolist() == [0, 99, 0]


def test_mesh_slab_layout_past_2_32(monkeypatch):
    """A rank's slab starting past 2^32 asks the host packer for each
    contig's piece at the right source offset and slab offset, padded to
    a multiple of 8 codes (the packer is recorded, not run: the codes are
    never touched)."""
    stub = _GenomeStub(LENGTHS)
    st = sketch_ops._Stream(stub, K, 1)  # the mesh's filter streams: w = 1
    starts = _starts(K + 1)
    calls = []

    def record(src, offsets, lengths, at, out_len, threads=0, out=None):
        calls.append((np.asarray(offsets).tolist(), np.asarray(lengths).tolist(),
                      np.asarray(at).tolist(), out_len))
        for a in out:
            a[:] = 0
        return out

    monkeypatch.setattr(sketch_ops.fio, "pack_stream", record)
    lo = int(starts[1]) + (1 << 31) - 10  # 10 bases before contig 1's end
    hi = int(starts[2]) + 1000
    assert pmesh._upload(st, lo, hi, torch.device("cpu")).shape == (hi - lo,)
    (offsets, lengths, at, out_len), = calls  # one group
    assert out_len == -(-(hi - lo) // 8) * 8
    assert offsets == [int(stub.offsets[1]) + (1 << 31) - 10, int(stub.offsets[2])]
    assert lengths == [13, 1000]
    assert at == [0, int(starts[2]) - lo]
    # the repeat walk's geometry past 2^32 k-mers: the ranks' slabs are
    # whole segments and cover the stream (a last rank may be empty)
    n_kmers = st.total - K + 1
    for d in (1, 2, 4):
        seg, slab = pmesh.repeat_geometry(n_kmers, d, 1 << 21)
        assert seg == 1 << 21 and slab % seg == 0 and d * slab >= n_kmers
