"""K5, the binned Bloom-filter sweep: the port's plain version against the
JAX package's Pallas sweep in interpret mode, bit for bit, at the bit
sizes of tests/test_bf_sweep.py; the common-BF cascade built through the
sweep against the JAX build with NTSYNT_BF_SWEEP=interpret; and, on a
CUDA card, the kernel against its plain version. Inputs are made from a
seed with numpy and handed to both packages. Tolerance 0 throughout."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ntsynt_tpu.ops import bf_sweep as j_sweep
from ntsynt_tpu_torch.ops import bf_sweep


def _split(canon):
    hi = (canon >> np.uint64(32)).astype(np.uint32)
    lo = (canon & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return jnp.asarray(hi), jnp.asarray(lo)


def _t(canon):
    return torch.from_numpy(canon.view(np.int64))


def _rand_canon(rng, n):
    return rng.integers(0, 1 << 64, n, dtype=np.uint64)


def _words(bits_log2):
    return torch.zeros((1 << bits_log2) // 32, dtype=torch.int32)


def _u32(words):
    return words.numpy().view(np.uint32)


@pytest.mark.parametrize("bits_log2", [16, 21, 22])
def test_k5_insert_matches_pallas(bits_log2):
    rng = np.random.default_rng(7)
    n = 5000
    canon = _rand_canon(rng, n)
    canon[100:200] = canon[0]  # duplicates
    canon[300] = np.uint64(0xFFFFFFFFFFFFFFFF)
    valid = rng.random(n) < 0.9
    hi, lo = _split(canon)
    ref = j_sweep.insert_segment(
        jnp.zeros((1 << bits_log2) // 32, jnp.uint32), hi, lo, jnp.asarray(valid), bits_log2,
        interpret=True,
    )
    got = bf_sweep.insert_segment(_words(bits_log2), _t(canon), torch.from_numpy(valid), bits_log2)
    np.testing.assert_array_equal(_u32(got), np.asarray(ref))
    # a second segment ORs over the bits already there
    more = _rand_canon(rng, 3000)
    mh, ml = _split(more)
    ref = j_sweep.insert_segment(ref, mh, ml, jnp.ones(3000, bool), bits_log2, interpret=True)
    bf_sweep.insert_segment(got, _t(more), torch.ones(3000, dtype=torch.bool), bits_log2)
    np.testing.assert_array_equal(_u32(got), np.asarray(ref))


@pytest.mark.parametrize("bits_log2", [16, 22])
def test_k5_cascade_matches_pallas(bits_log2):
    rng = np.random.default_rng(9)
    base = _rand_canon(rng, 4000)
    nxt = np.concatenate([base[:2000], _rand_canon(rng, 2000)])  # half shared
    rng.shuffle(nxt)
    valid = rng.random(len(nxt)) < 0.95
    n_words = (1 << bits_log2) // 32
    h0, l0 = _split(base)
    j_prev = j_sweep.insert_segment(
        jnp.zeros(n_words, jnp.uint32), h0, l0, jnp.ones(len(base), bool), bits_log2,
        interpret=True,
    )
    hi, lo = _split(nxt)
    ref = j_sweep.cascade_segment(
        j_prev, jnp.zeros(n_words, jnp.uint32), hi, lo, jnp.asarray(valid), bits_log2,
        interpret=True,
    )
    prev = bf_sweep.insert_segment(
        _words(bits_log2), _t(base), torch.ones(len(base), dtype=torch.bool), bits_log2
    )
    np.testing.assert_array_equal(_u32(prev), np.asarray(j_prev))
    got = bf_sweep.cascade_segment(prev, _words(bits_log2), _t(nxt), torch.from_numpy(valid),
                                   bits_log2)
    np.testing.assert_array_equal(_u32(got), np.asarray(ref))
    assert int(np.unpackbits(_u32(got).view(np.uint8)).sum()) > 0


def test_k5_all_in_one_cell_matches_pallas_overflow():
    """Every key in one 2^20-bit cell: the JAX sweep overflows its pass
    budget and falls back to the scatter path; the port has no per-cell
    capacity, so its words must come out the same."""
    rng = np.random.default_rng(10)
    bits_log2, n = 22, 40000
    canon = rng.integers(0, 1 << 20, n, dtype=np.uint64)
    hi, lo = _split(canon)
    n_words = (1 << bits_log2) // 32
    ref = j_sweep.insert_segment(
        jnp.zeros(n_words, jnp.uint32), hi, lo, jnp.ones(n, bool), bits_log2, interpret=True
    )
    got = bf_sweep.insert_segment(_words(bits_log2), _t(canon), torch.ones(n, dtype=torch.bool),
                                  bits_log2)
    np.testing.assert_array_equal(_u32(got), np.asarray(ref))
    # cascade of the same keys over a prev holding every other of them
    half = canon[::2].copy()
    hh, hl = _split(half)
    j_prev = j_sweep.insert_segment(
        jnp.zeros(n_words, jnp.uint32), hh, hl, jnp.ones(len(half), bool), bits_log2,
        interpret=True,
    )
    ref = j_sweep.cascade_segment(j_prev, jnp.zeros(n_words, jnp.uint32), hi, lo,
                                  jnp.ones(n, bool), bits_log2, interpret=True)
    prev = torch.from_numpy(np.asarray(j_prev).view(np.int32).copy())
    got = bf_sweep.cascade_segment(prev, _words(bits_log2), _t(canon),
                                   torch.ones(n, dtype=torch.bool), bits_log2)
    np.testing.assert_array_equal(_u32(got), np.asarray(ref))


@pytest.mark.parametrize("bits_log2", [16, 19, 20, 32])
def test_k5_cells_partition_the_filter(bits_log2):
    """The kernel's binning (csrc/bf_sweep.cu): cell = bit >> (cell_log2
    + 5) and the bit within the cell = bit & (2^(cell_log2 + 5) - 1),
    replayed here with numpy from ops/bf_sweep.geometry, rebuild every
    key's word and mask; filters below one cell are a single cell."""
    n_words, cell_log2, n_cells = bf_sweep.geometry(bits_log2)
    assert n_cells << cell_log2 == n_words
    assert cell_log2 == min(bf_sweep.CELL_LOG2, bits_log2 - 5)
    # one block holds a cell of new words and, for the cascade, prev's
    assert 2 * 4 << cell_log2 <= 227 * 1024
    rng = np.random.default_rng(bits_log2)
    canon = _rand_canon(rng, 4096)
    bit = canon & np.uint64((1 << bits_log2) - 1)
    cell = bit >> np.uint64(cell_log2 + 5)
    in_cell = bit & np.uint64((1 << (cell_log2 + 5)) - 1)
    assert (cell < n_cells).all()
    word = (cell << np.uint64(cell_log2)) + (in_cell >> np.uint64(5))
    np.testing.assert_array_equal(word, bit >> np.uint64(5))
    np.testing.assert_array_equal(in_cell & np.uint64(31), canon & np.uint64(31))


@pytest.mark.parametrize("env", [None, "interpret", "tpu", "1", "0", "off"])
def test_k5_mode_reads_the_jax_environment(env, monkeypatch):
    if env is None:
        monkeypatch.delenv("NTSYNT_BF_SWEEP", raising=False)
    else:
        monkeypatch.setenv("NTSYNT_BF_SWEEP", env)
    monkeypatch.delenv("NTSYNT_NO_PALLAS", raising=False)
    assert bf_sweep.mode() == j_sweep.mode()
    monkeypatch.setenv("NTSYNT_NO_PALLAS", "1")
    assert bf_sweep.mode() is None and j_sweep.mode() is None
    for b in (16, 32, 33, 36):
        assert bf_sweep.supported(b) == j_sweep.supported(b)


def test_k5_rejects_bad_input():
    with pytest.raises(ValueError):
        bf_sweep.insert_segment(torch.zeros(8, dtype=torch.int32),
                                torch.zeros(1, dtype=torch.int64),
                                torch.ones(1, dtype=torch.bool), 33)
    with pytest.raises(ValueError):
        bf_sweep.insert_segment(torch.zeros(7, dtype=torch.int32),
                                torch.zeros(1, dtype=torch.int64),
                                torch.ones(1, dtype=torch.bool), 16)
    with pytest.raises(ValueError):
        bf_sweep.cascade_segment(_words(17), _words(16), torch.zeros(1, dtype=torch.int64),
                                 torch.ones(1, dtype=torch.bool), 16)


def test_build_common_bf_sweep_matches_jax(monkeypatch, tmp_path):
    """build_common_bf with NTSYNT_BF_SWEEP set: the port's cascade goes
    through K5 (every level, no K4) and equals the JAX cascade built
    through its sweep in interpret mode, and the plain K4 cascade."""
    from ntsynt_tpu.io.fasta import read_fasta as j_read_fasta
    from ntsynt_tpu.ops import bf_build as j_bf_build
    from ntsynt_tpu_torch.io.fasta import read_fasta
    from ntsynt_tpu_torch.ops import bf_build, bloom

    rng = np.random.default_rng(11)
    dec = np.frombuffer(b"ACGT", np.uint8)
    base = rng.integers(0, 4, 30000)
    paths = []
    for name, seq in (("a.fa", base), ("b.fa", np.where(rng.random(30000) < 0.01, 0, base))):
        p = tmp_path / name
        p.write_text(f">c1\n{dec[seq].tobytes().decode()}\n>c2\n{dec[seq[:5000]].tobytes().decode()}\n")
        paths.append(str(p))

    monkeypatch.setenv("NTSYNT_BF_SWEEP", "interpret")
    j_bf_build._insert_stream_fn.cache_clear()
    try:
        ref = j_bf_build.build_common_bf([j_read_fasta(p) for p in paths], k=24, fpr=0.025,
                                         chunk=1 << 14)
    finally:
        j_bf_build._insert_stream_fn.cache_clear()

    calls = []
    real_sweep, real_k4 = bf_sweep.insert_segment, bloom.insert_words

    def sweep_spy(*a, **kw):
        calls.append("sweep")
        return real_sweep(*a, **kw)

    def k4_spy(*a, **kw):
        calls.append("k4")
        return real_k4(*a, **kw)

    monkeypatch.setattr(bf_sweep, "insert_segment", sweep_spy)
    monkeypatch.setattr(bloom, "insert_words", k4_spy)
    genomes = [read_fasta(p) for p in paths]
    got = bf_build.build_common_bf(genomes, k=24, fpr=0.025, device="cpu")
    assert calls == ["sweep", "sweep"]
    np.testing.assert_array_equal(got.words_u32(), np.asarray(ref.words))
    monkeypatch.delenv("NTSYNT_BF_SWEEP")
    calls.clear()
    plain = bf_build.build_common_bf(genomes, k=24, fpr=0.025, device="cpu")
    assert calls == ["k4", "k4"]
    np.testing.assert_array_equal(plain.words_u32(), got.words_u32())


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no interpret mode)")


@pytest.mark.cuda
def test_cuda_k5_matches_plain():
    _need_cuda()
    rng = np.random.default_rng(700)
    n = 1 << 20
    canon = torch.from_numpy(_rand_canon(rng, n).view(np.int64)).cuda()
    valid = torch.from_numpy(rng.random(n) < 0.9).cuda()
    for bits in (16, 20, 24, 32):
        words = torch.zeros((1 << bits) // 32, dtype=torch.int32, device="cuda")
        bf_sweep.insert_segment(words, canon, valid, bits)
        ref = bf_sweep.sweep_plain(torch.zeros_like(words), canon, valid, bits)
        assert torch.equal(words, ref)
        half = bf_sweep.sweep_plain(torch.zeros_like(words), canon[::2], valid[::2], bits)
        new = bf_sweep.cascade_segment(half, torch.zeros_like(words), canon, valid, bits)
        assert torch.equal(new, bf_sweep.sweep_plain(torch.zeros_like(words), canon, valid,
                                                     bits, prev=half))
