"""The packed device stream on the card (no JAX: these run where the
card is, ``python -m pytest tests/test_torch_packed_stream_cuda.py -m
cuda --noconftest -q``); each skips without one. The CPU side, against
the JAX package, is tests/test_torch_packed_stream.py.

* The unpack kernel (csrc/unpack.cu) against unpack_plain and the codes
  it was packed from, on both routes (n/8 a multiple of 16 with aligned
  pointers, and not), writing into views at offsets.
* The grouped upload on the card (pinned staging, side stream, events)
  against the same upload on the CPU: the assembled codes, the groups'
  views, the common filter's words for several group lengths, and the
  launches (one unpack a group).
* K3 reading the legit bits at bit offsets against its plain version.

Inputs are made from a seed with numpy; tolerance 0 throughout.
"""

import numpy as np
import pytest
import torch

from ntsynt_tpu_torch.io import fasta as fio
from ntsynt_tpu_torch.ops import _kernels, bf_build, bloom, sketch, sketch_device, unpack

K, W = 24, 100


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no interpret mode)")


def _genome(rng, lengths):
    """A PackedGenome of random contigs with N runs, laid end to end."""
    lengths = np.asarray(lengths, dtype=np.int64)
    codes = rng.integers(0, 4, int(lengths.sum())).astype(np.uint8)
    codes[rng.random(len(codes)) < 0.002] = 4
    zeros = np.zeros(len(lengths), np.int64)
    return fio.PackedGenome(
        path="g.fa", name="g.fa", contig_names=[f"c{i}" for i in range(len(lengths))],
        lengths=lengths, offsets=np.concatenate([[0], np.cumsum(lengths)[:-1]]).astype(np.int64),
        codes=codes, soft=None, fai_offsets=zeros, fai_linebases=zeros, fai_linewidth=zeros)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [8, 128, 136, 8 * 1021, (1 << 20) + 8, 1 << 22])
def test_cuda_unpack_matches_plain(n):
    _need_cuda()
    rng = np.random.default_rng(n)
    codes = rng.integers(0, 5, n).astype(np.uint8)
    p2, nb = fio.pack_stream(codes, np.zeros(1, np.int64), np.array([n]),
                             np.zeros(1, np.int64), n)
    p2, nb = torch.from_numpy(p2).cuda(), torch.from_numpy(nb).cuda()
    want = torch.from_numpy(codes).cuda()
    for off in (0, 8, 16):
        big = torch.full((n + 64,), 9, dtype=torch.uint8, device="cuda")
        unpack.unpack(p2, nb, out=big[off : off + n])
        torch.cuda.synchronize()
        assert torch.equal(big[off : off + n], want), off
        assert torch.equal(big[off : off + n], unpack.unpack_plain(p2, nb)), off
        assert bool((big[:off] == 9).all()) and bool((big[off + n :] == 9).all()), off


@pytest.mark.cuda
@pytest.mark.parametrize("group", [1 << 12, 3 << 12, 1 << 16])
def test_cuda_grouped_upload_matches_cpu(monkeypatch, group):
    """Groups of a small segment's multiples: the card's assembled codes
    and group views equal the CPU's, one unpack launch a group, and the
    common filter built from the groups as they land equals the CPU's."""
    _need_cuda()
    monkeypatch.setattr(bf_build, "SEG_KMERS", 1 << 12)
    monkeypatch.setattr(sketch, "GROUP_KMERS", group)
    rng = np.random.default_rng(group)
    g = _genome(rng, [150_001, 30, 77_777, 5])
    cpu = sketch.DeviceStream(g, K, W, "cpu")
    want_views = [v.clone() for v in cpu.groups()]
    _kernels.reset_launches()
    card = sketch.DeviceStream(g, K, W, "cuda")
    views = [v.clone() for v in card.groups()]
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["unpack"] == card.n_groups == len(want_views) > 1
    for v, want in zip(views, want_views):
        assert torch.equal(v.cpu(), want)
    assert torch.equal(card.codes.cpu(), cpu.codes)
    assert torch.equal(card.legit.cpu(), cpu.legit)
    words = []
    for dev in ("cpu", "cuda"):
        bf = bloom.BloomFilter(1 << 22, K, device=dev)
        bf_build.insert_stream(bf, sketch.DeviceStream(g, K, W, dev), K)
        words.append(bf.words.cpu())
    assert torch.equal(words[0], words[1])


@pytest.mark.cuda
def test_cuda_sketch_of_grouped_stream_matches_cpu(monkeypatch):
    """The sketch over a stream uploaded in several groups, segments of
    a few windows (legit bits read at offsets that are not multiples of
    8 only through the mesh; here at segment starts), card against CPU."""
    _need_cuda()
    rng = np.random.default_rng(1408)
    g = _genome(rng, [120_000, 60, 40_000])
    monkeypatch.setattr(sketch, "GROUP_KMERS", 1 << 14)
    got = []
    for dev in ("cpu", "cuda"):
        ds = sketch.DeviceStream(g, K, W, dev)
        got.append(sketch_device.sketch_stream(ds.codes, ds.legit, K, W, seg=1 << 12))
    for a, b in zip(*got):
        np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [1, 7, 13, 4099])
def test_cuda_k3_legit_bit_offsets(offset):
    _need_cuda()
    rng = np.random.default_rng(offset)
    nw = 3 * sketch_device.COMPACT_TILE + 17
    arg = np.maximum.accumulate(rng.integers(0, nw + 50, nw)).astype(np.int64)
    minv = rng.integers(-(1 << 62), 1 << 62, nw)
    minv[rng.random(nw) < 0.1] = -1
    mask = np.concatenate([rng.random(offset) < 0.5, rng.random(nw) < 0.9])
    bits = torch.from_numpy(np.packbits(mask, bitorder="little")).cuda()
    a, m = torch.from_numpy(arg).cuda(), torch.from_numpy(minv).cuda()
    got = sketch_device.compact_minimizers(a, m, bits, offset)
    ref = sketch_device.compact_plain(a, m, bits, offset)
    torch.cuda.synchronize()
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    assert got[0].shape[0] > 0
