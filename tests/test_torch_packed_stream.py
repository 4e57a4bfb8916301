"""The port's packed device stream against the JAX package on the CPU.

* ``io.fasta.pack_stream`` (the host library's fused layout and pack)
  against the JAX package's ``pack_stream_native`` and its NumPy
  ``_pack_stream_host`` + ``_pack_nbits_host``, whole streams and
  ranges of them: N runs, separators, contigs shorter than k, lengths
  that are not multiples of 8.
* ``ops.unpack.unpack_plain`` (and the wrapper on CPU tensors) against
  ``_unpack_stream_fn`` and the JAX mesh's ``_unpack_row``.
* The legit-window bits against ``_Stream.legit_windows()``, at odd bit
  offsets too, and K3's plain version on bits against the bool form.
* The grouped upload: the assembled codes and the groups' views, and the
  common filter's words for groups of one, three and eight segments
  (a small segment) and a partial last group, against the JAX cascade
  and a whole-stream insert, segment for segment.
* ``release_plan`` at 1.125 bytes a base.

Inputs are made from a seed with numpy; tolerance 0 throughout.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ntsynt_tpu.io import fasta as j_fio
from ntsynt_tpu.ops import bf_build as j_bf_build
from ntsynt_tpu.ops import sketch as j_sketch
from ntsynt_tpu.parallel import mesh as j_mesh
from ntsynt_tpu_torch.core import pipeline as tpipe
from ntsynt_tpu_torch.io import fasta as fio
from ntsynt_tpu_torch.ops import bf_build, nthash, sketch, sketch_device, unpack

K, W = 24, 100
DEC = np.array(list("ACGTN"))


def _write(path, contigs):
    with open(path, "w") as f:
        for name, codes in contigs:
            f.write(f">{name}\n")
            s = "".join(DEC[codes])
            f.write("\n".join(s[i : i + 60] for i in range(0, len(s), 60)) + "\n")
    return str(path)


@pytest.fixture(scope="module")
def genomes(tmp_path_factory):
    """Two genomes: contigs longer and shorter than k (and shorter than
    w + k), N runs, an empty contig; and a copy with SNPs whose k-mers
    span several small segments."""
    rng = np.random.default_rng(1401)
    tmp = tmp_path_factory.mktemp("torch_packed_stream")
    a = rng.integers(0, 4, 21_001).astype(np.uint8)
    a[5_000:5_033] = 4  # an N run
    a[rng.random(len(a)) < 0.002] = 4  # single Ns
    c2 = rng.integers(0, 4, 3_007).astype(np.uint8)
    b = a.copy()
    snp = rng.random(len(b)) < 0.003
    b[snp] = (b[snp] + rng.integers(1, 4, int(snp.sum()))) % 4
    pa = _write(tmp / "a.fa", [("c1", a), ("short", a[:13]), ("empty", a[:0]), ("mid", a[:110]),
                               ("c2", c2)])
    pb = _write(tmp / "b.fa", [("c1", b), ("c2", c2[::-1].copy()), ("tiny", c2[:5])])
    return pa, pb


def _streams(path):
    """The port's and the JAX package's streams of one genome."""
    return (sketch._Stream(fio.read_fasta(path), K, W),
            j_sketch._Stream(j_fio.read_fasta(path, native=False), K, W))


def _round8(n):
    return -(-n // 8) * 8


@pytest.mark.parametrize("pad", [0, 8, 40])
def test_pack_stream_equals_jax_packers(genomes, pad):
    """The whole stream, padded to out_len = round8(total) + pad (the
    total is not a multiple of 8): the port's fused pass against the JAX
    package's native packer and its NumPy pair, byte for byte."""
    for path in genomes:
        ts, js = _streams(path)
        assert ts.total % 8 and ts.total == js.total
        out_len = _round8(ts.total) + pad
        g = ts.genome
        packed2, nbits = fio.pack_stream(g.codes, g.offsets, g.lengths, ts.starts, out_len)
        native = j_fio.pack_stream_native(js._src, js.genome.offsets, js.genome.lengths,
                                          js.starts, out_len)
        assert native is not None, "the JAX package's native packer is not built"
        buf = np.full(out_len, 4, np.uint8)
        buf[: js.total] = js.codes
        for ref2, refn in (native, (j_sketch._pack_stream_host(buf),
                                    j_sketch._pack_nbits_host(buf))):
            np.testing.assert_array_equal(packed2, ref2)
            np.testing.assert_array_equal(nbits, refn)


@pytest.mark.parametrize("lo,hi", [(0, 24), (7, 8_000), (21_000, 21_200), (21_100, 22_001),
                                   (24_000, 24_200), (3, 3)])
def test_pack_range_equals_jax_slice(genomes, lo, hi):
    """A range of the stream (a group, or a mesh slab: odd starts, ranges
    over separators and short contigs, past the stream's end) packs as
    the JAX package packs its _Stream.slice padded with code 4."""
    ts, js = _streams(genomes[0])
    n8 = _round8(hi - lo) + 8
    packed2, nbits = ts.pack(lo, hi, n8)
    buf = np.full(n8, 4, np.uint8)
    piece = js.slice(lo, hi)
    buf[: len(piece)] = piece
    np.testing.assert_array_equal(packed2, j_sketch._pack_stream_host(buf))
    np.testing.assert_array_equal(nbits, j_sketch._pack_nbits_host(buf))


@pytest.mark.parametrize("n", [8, 64, 8 * 1021, 8 * 4096 + 8])
def test_unpack_plain_equals_jax(n):
    rng = np.random.default_rng(n)
    buf = rng.integers(0, 5, n).astype(np.uint8)
    p2, nb = j_sketch._pack_stream_host(buf), j_sketch._pack_nbits_host(buf)
    got = unpack.unpack_plain(torch.from_numpy(p2), torch.from_numpy(nb)).numpy()
    np.testing.assert_array_equal(got, buf)
    np.testing.assert_array_equal(got, np.asarray(j_sketch._unpack_stream_fn(n)(
        jnp.asarray(p2), jnp.asarray(nb))))
    np.testing.assert_array_equal(got, np.asarray(j_mesh._unpack_row(jnp.asarray(p2),
                                                                      jnp.asarray(nb))))
    # the wrapper on CPU tensors, into a view at an offset of a larger buffer
    big = torch.full((n + 16,), 9, dtype=torch.uint8)
    unpack.unpack(torch.from_numpy(p2), torch.from_numpy(nb), out=big[8 : 8 + n])
    np.testing.assert_array_equal(big[8 : 8 + n].numpy(), buf)
    assert (big[:8] == 9).all() and (big[8 + n :] == 9).all()
    with pytest.raises(ValueError):
        unpack.unpack(torch.from_numpy(p2), torch.from_numpy(nb), out=big[: n - 8])


def test_legit_bits_equal_jax_legit_windows(genomes):
    """The port's legit bits, read at bit offsets 0, odd ones and ones
    inside and across contig gaps, against the JAX package's bool mask;
    bits_any against .any() on the same ranges."""
    for path in genomes:
        ts, js = _streams(path)
        want = js.legit_windows()
        bits = ts.legit_bits()
        assert ts.n_windows == len(want) and len(bits) == -(-len(want) // 8)
        got = sketch_device.legit_from_bits(torch.from_numpy(bits), 0, len(want)).numpy()
        np.testing.assert_array_equal(got, want)
        for off in (1, 3, 7, 13, 20_990, len(want) - 9):
            for n in (1, 5, 8, 77, len(want) - off):
                n = min(n, len(want) - off)
                got = sketch_device.legit_from_bits(torch.from_numpy(bits), off, n).numpy()
                np.testing.assert_array_equal(got, want[off : off + n], err_msg=f"{off} {n}")
                assert sketch.bits_any(bits, off, off + n) == bool(want[off : off + n].any())
        assert not sketch.bits_any(bits, 5, 5)


def _compact_bool(arg, minv, legit):
    """K3's plain version with a bool legit mask (its form before the
    mask became bits)."""
    live = legit & (minv != -1)
    prev_live = np.concatenate([[False], live[:-1]])
    prev_arg = np.concatenate([[-1], arg[:-1]])
    flag = live & (~prev_live | (arg != prev_arg))
    return arg[flag], minv[flag]


@pytest.mark.parametrize("offset", [0, 3, 8, 13])
def test_compact_plain_bits_equal_bool_form(offset):
    """Windows with gaps in the mask: compact_plain and compact_minimizers
    (CPU) on the bits, the mask's first window at offset, against the
    bool form on the same windows."""
    rng = np.random.default_rng(1407 + offset)
    nw = 5_003
    arg = np.maximum.accumulate(rng.integers(0, nw + 50, nw)).astype(np.int64)
    minv = rng.integers(-(1 << 62), 1 << 62, nw)
    minv[rng.random(nw) < 0.1] = -1
    legit = rng.random(nw) < 0.9
    legit[1_000:1_300] = False
    pad = rng.random(offset) < 0.5  # other windows' bits before the mask
    bits = torch.from_numpy(np.packbits(np.concatenate([pad, legit]), bitorder="little"))
    want = _compact_bool(arg, minv, legit)
    a, m = torch.from_numpy(arg), torch.from_numpy(minv)
    for got in (sketch_device.compact_plain(a, m, bits, offset),
                sketch_device.compact_minimizers(a, m, bits, offset)):
        np.testing.assert_array_equal(got[0].numpy(), want[0])
        np.testing.assert_array_equal(got[1].numpy(), want[1])
    with pytest.raises(ValueError):  # too few bits for the windows
        sketch_device.compact_minimizers(a, m, bits[:-1], offset + 8)


@pytest.mark.parametrize("group", [1024, 3 * 1024, 8 * 1024, 8 * 4096])
def test_grouped_upload_assembles_the_stream(genomes, monkeypatch, group):
    """The assembled codes equal the JAX stream, and each group's view is
    its k-mers' codes; a stream of one group, and of several with a
    partial last one."""
    monkeypatch.setattr(sketch, "GROUP_KMERS", group)
    ts, js = _streams(genomes[0])
    up = sketch.DeviceStream(ts.genome, K, W, "cpu")
    views = list(up.groups())
    assert len(views) == up.n_groups == -(-(ts.total - K + 1) // group)
    for g, v in enumerate(views):
        a = g * group
        np.testing.assert_array_equal(v.numpy(), js.codes[a : a + group + K - 1])
    np.testing.assert_array_equal(up.codes.numpy(), js.codes)
    with pytest.raises(RuntimeError):
        next(up.groups())
    # asked for the codes first, the groups are sent without a walk
    np.testing.assert_array_equal(
        sketch.DeviceStream(ts.genome, K, W, "cpu").codes.numpy(), js.codes)


@pytest.mark.parametrize("segs", [1, 3, 8])
def test_filter_words_equal_for_group_lengths(genomes, monkeypatch, segs):
    """The common filter through the grouped streams, groups of segs
    segments of 1024 k-mers (the last group partial), equals the JAX
    cascade's words, and hashes the same segments as a whole-stream
    insert."""
    monkeypatch.setattr(bf_build, "SEG_KMERS", 1024)
    sizes = []
    hash_kmers = nthash.hash_kmers

    def recording(codes, k, n):
        sizes.append(n)
        return hash_kmers(codes, k, n)

    monkeypatch.setattr(nthash, "hash_kmers", recording)
    gs = sorted((fio.read_fasta(p) for p in genomes), key=lambda g: g.path)
    num_bits = 1 << 20
    monkeypatch.setattr(sketch, "GROUP_KMERS", segs * 1024)
    streams = [sketch.DeviceStream(g, K, W, "cpu") for g in gs]
    assert all((s.stream.total - K + 1) % (segs * 1024) for s in streams)  # partial last
    bf = bf_build.build_common_bf_from_device(
        [(g.name, lambda s=s: s) for g, s in zip(gs, streams)], K, num_bits, "cpu")
    grouped, sizes[:] = list(sizes), []
    # one group holds the whole stream
    monkeypatch.setattr(sketch, "GROUP_KMERS", 1 << 30)
    whole = bf_build.build_common_bf_from_device(
        [(g.name, lambda g=g: sketch.DeviceStream(g, K, W, "cpu")) for g in gs],
        K, num_bits, "cpu")
    assert grouped == sizes
    assert torch.equal(bf.words, whole.words)
    ref = j_bf_build.build_common_bf([j_fio.read_fasta(p) for p in genomes], K,
                                     bf_bytes=num_bits // 8, chunk=1024)
    np.testing.assert_array_equal(bf.words_u32(), np.asarray(ref.words))
    # the streams serve the sketch after their groups fed the cascade
    for s, g in zip(streams, gs):
        ref_codes = sketch.DeviceStream(g, K, W, "cpu").codes
        assert torch.equal(s.codes, ref_codes)


def test_release_plan_counts_1_125_bytes_a_base():
    """A stream holds its unpacked codes and its legit bits: 1.125 bytes
    a base (the JAX stream's, with 1-bit legit words)."""
    assert tpipe.STREAM_BYTES_PER_BASE == 1.125
    levels = 2 * ((1 << 33) // 8)
    sizes = {"a.fa": 800_000_000, "b.fa": 400_000_000}
    fits = levels + 900_000_000 + 450_000_000
    assert tpipe.release_plan(sizes, 1 << 33, fits) == set()
    assert tpipe.release_plan(sizes, 1 << 33, fits - 1) == {"a.fa"}
    # at the former 2.0 bytes a base this budget would have released a.fa
    assert tpipe.release_plan(sizes, 1 << 33, levels + 2_000_000_000) == set()
