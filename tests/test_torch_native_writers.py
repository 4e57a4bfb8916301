"""The port's text writers, whose records the host library formats
(io/textfmt.py, csrc/host/textfmt.cpp), against the JAX package's Python
writers, byte for byte: sketch TSVs (io/sketch_tsv.write_sketch_tsv) and
the .mx.dot (SyntenyDetector.write_dot), each also with a buffer small
enough that a chunk ends inside a line."""

import numpy as np
import pytest

from ntsynt_tpu.core.synteny import SyntenyDetector as JaxDetector
from ntsynt_tpu.io import fasta as jax_fasta
from ntsynt_tpu.io import sketch_tsv as jax_tsv
from ntsynt_tpu_torch.core.synteny import SyntenyDetector
from ntsynt_tpu_torch.graph.mxgraph import MinimizerGraph
from ntsynt_tpu_torch.io import fasta as fio
from ntsynt_tpu_torch.io import sketch_tsv, textfmt

U64_MAX = (1 << 64) - 1
# the default buffer, and one that ends chunks inside records' lines
CHUNKS = {"default": None, "small": 211}


def _kmers(rng, n, k, letters=b"ACGT"):
    return np.frombuffer(letters, np.uint8)[rng.integers(0, len(letters), (n, k))]


def _contig(rng, name, n, k, letters=b"ACGT"):
    hashes = rng.integers(0, U64_MAX, n, dtype=np.uint64, endpoint=True)
    positions = np.sort(rng.integers(0, 1 << 20, n)).astype(np.int64)
    return name, hashes, positions, _kmers(rng, n, k, letters)


def _empty_contigs(rng, k):
    return [_contig(rng, "c0", 0, k), _contig(rng, "c1", 7, k), _contig(rng, "c2", 0, k)]


def _soft_masked(rng, k):
    return [_contig(rng, "lower", 5, k, b"acgt"), _contig(rng, "mixed", 300, k, b"ACGTacgt")]


def _extreme_hashes(rng, k):
    name, h, p, s = _contig(rng, "c", 6, k)
    h[:3] = [0, U64_MAX, 9]
    h[-1] = U64_MAX - 1
    return [(name, h, p, s)]


def _far_positions(rng, k):
    name, h, p, s = _contig(rng, "c", 5, k)
    p[:] = [0, 1, (1 << 32) - 1, 1 << 32, (1 << 40) + 12345]
    return [(name, h, p, s)]


def _single_records(rng, k):
    """Contigs of one record: no separator on any line."""
    return [_contig(rng, f"c{i}", 1, k) for i in range(4)]


TSV_CASES = {"empty_contigs": _empty_contigs, "soft_masked": _soft_masked,
             "extreme_hashes": _extreme_hashes, "far_positions": _far_positions,
             "single_records": _single_records}


def _jax_records(records):
    """The records with their k-mers as a list of str."""
    return [(name, h, p, [bytes(x).decode() for x in s]) for name, h, p, s in records]


@pytest.fixture
def chunk(request, monkeypatch):
    if CHUNKS[request.param] is not None:
        monkeypatch.setattr(textfmt, "CHUNK_BYTES", CHUNKS[request.param])


@pytest.mark.parametrize("chunk", list(CHUNKS), indirect=True)
@pytest.mark.parametrize("k", [24, 15])
@pytest.mark.parametrize("case", list(TSV_CASES))
def test_sketch_tsv_bytes(tmp_path, chunk, case, k):
    records = TSV_CASES[case](np.random.default_rng(k), k)
    n = sketch_tsv.write_sketch_tsv(str(tmp_path / "port.tsv"), iter(records))
    jax_tsv.write_sketch_tsv(str(tmp_path / "jax.tsv"), _jax_records(records))
    got = (tmp_path / "port.tsv").read_bytes()
    assert got == (tmp_path / "jax.tsv").read_bytes()
    assert n == sum(len(p) for _, _, p, _ in records)


@pytest.mark.parametrize("chunk", list(CHUNKS), indirect=True)
def test_sketch_tsv_of_a_soft_masked_genome(tmp_path, chunk):
    """Records as the pipeline makes them (PackedGenome.kmer_bytes of a
    soft-masked FASTA) against the JAX genome's kmer_strings."""
    rng = np.random.default_rng(5)
    k = 21
    seqs = []
    for ln in (400, 50, 900):
        s = np.frombuffer(b"ACGTacgt", np.uint8)[rng.integers(0, 8, ln)]
        s[rng.random(ln) < 0.01] = ord("N")
        seqs.append(s.tobytes().decode())
    fa = tmp_path / "g.fa"
    fa.write_text("".join(f">c{i}\n{s}\n" for i, s in enumerate(seqs)))
    port, jax = fio.read_fasta(str(fa)), jax_fasta.read_fasta(str(fa))
    ours, theirs = [], []
    for ci, s in enumerate(seqs):
        raw = np.frombuffer(s.encode(), np.uint8)
        ok = np.isin(raw, np.frombuffer(b"ACGTacgt", np.uint8))
        pos = np.flatnonzero(np.lib.stride_tricks.sliding_window_view(ok, k).all(axis=1))[::7]
        h = rng.integers(0, U64_MAX, len(pos), dtype=np.uint64, endpoint=True)
        ours.append((f"c{ci}", h, pos, port.kmer_bytes(ci, pos, k)))
        theirs.append((f"c{ci}", h, pos, jax.kmer_strings(ci, pos, k)))
    sketch_tsv.write_sketch_tsv(str(tmp_path / "port.tsv"), ours)
    jax_tsv.write_sketch_tsv(str(tmp_path / "jax.tsv"), theirs)
    assert (tmp_path / "port.tsv").read_bytes() == (tmp_path / "jax.tsv").read_bytes()
    assert any(c.islower() for c in (tmp_path / "port.tsv").read_text())


def test_kmer_bytes_rejects_kmers_outside_the_contig(tmp_path):
    fa = tmp_path / "g.fa"
    fa.write_text(">a\nACGTACGTAC\n>b\nacgtacgtac\n")
    g = fio.read_fasta(str(fa))
    assert g.kmer_bytes(1, [0, 6], 4).tobytes() == b"acgtgtac"
    for pos in ([7], [-1]):
        with pytest.raises(ValueError):
            g.kmer_bytes(0, pos, 4)


def test_sketch_tsv_rejects_mismatched_columns(tmp_path):
    rng = np.random.default_rng(1)
    name, h, p, s = _contig(rng, "c", 4, 24)
    with pytest.raises(ValueError):
        sketch_tsv.write_sketch_tsv(str(tmp_path / "a.tsv"), [(name, h, p[:3], s)])
    with pytest.raises(TypeError):
        sketch_tsv.write_sketch_tsv(str(tmp_path / "b.tsv"), [(name, h, p, s[:3])])
    with pytest.raises(TypeError):
        sketch_tsv.write_sketch_tsv(str(tmp_path / "c.tsv"), [(name, h, p, ["ACGT"] * 4)])


def _graph(n_nodes, n_edges, rng, max_weight=4):
    u = rng.integers(0, max(n_nodes, 1), n_edges).astype(np.int32)
    v = rng.integers(0, max(n_nodes, 1), n_edges).astype(np.int32)
    w = rng.integers(1, max_weight + 1, n_edges).astype(np.int32)
    h = rng.integers(0, U64_MAX, n_nodes, dtype=np.uint64, endpoint=True)
    if n_nodes:
        h[0] = U64_MAX
    return MinimizerGraph(h, u, v, w)


DOT_CASES = {
    "empty": (0, 0, 4),
    "no_edges": (9, 0, 4),
    "small": (50, 80, 4),
    "heavy_weights": (40, 60, 1000),
    "past_a_million_nodes": (1_000_123, 3_000, 11),
}


@pytest.mark.parametrize("chunk", list(CHUNKS), indirect=True)
@pytest.mark.parametrize("case", list(DOT_CASES))
def test_dot_bytes(tmp_path, chunk, case):
    n_nodes, n_edges, max_weight = DOT_CASES[case]
    g = _graph(n_nodes, n_edges, np.random.default_rng(n_nodes + n_edges), max_weight)
    if n_nodes > 1_000_000:
        g.eu[:2] = [n_nodes - 1, 1_000_001]  # ids above 10^6 in the edge lines too
    port = object.__new__(SyntenyDetector)
    n = port.write_dot(str(tmp_path / "port.dot"), g)
    JaxDetector.write_dot(object.__new__(JaxDetector), str(tmp_path / "jax.dot"), g)
    assert (tmp_path / "port.dot").read_bytes() == (tmp_path / "jax.dot").read_bytes()
    assert n == n_nodes + n_edges


def test_dot_rejects_mismatched_edges(tmp_path):
    g = _graph(5, 4, np.random.default_rng(0))
    g.weight = g.weight[:3]
    with pytest.raises(ValueError):
        object.__new__(SyntenyDetector).write_dot(str(tmp_path / "a.dot"), g)


def test_a_record_larger_than_the_buffer_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(textfmt, "CHUNK_BYTES", 40)
    rng = np.random.default_rng(2)
    with pytest.raises(ValueError, match="does not fit"):
        sketch_tsv.write_sketch_tsv(str(tmp_path / "a.tsv"), [_contig(rng, "c", 2, 24)])
