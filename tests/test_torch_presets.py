"""The port (--device cpu) against the JAX package on the divergence
presets: the shipped presets at the default w = 1000 and the '> 10%'
preset on a diverged pair. Every artifact of the two CLIs must be
byte-identical. Tolerance 0. (The helpers are
tests/test_torch_published_shapes.py's.)"""

import numpy as np
import pytest

from test_torch_published_shapes import _assert_same, _rows, _run_both, mutate, write_fasta


@pytest.fixture(scope="module")
def default_pair(tmp_path_factory):
    """tests/test_e2e.py::test_default_params_e2e's 2 x 2 Mbp pair (B
    inverted at 0.8-1.2 Mbp, 0.1% SNPs)."""
    tmp = tmp_path_factory.mktemp("torch_default_pair")
    rng = np.random.default_rng(77)
    base = rng.integers(0, 4, 2_000_000).astype(np.uint8)
    mut = base.copy()
    mut[800_000:1_200_000] = mut[800_000:1_200_000][::-1] ^ 3
    snp = rng.random(len(mut)) < 0.001
    mut[snp] = (mut[snp] + rng.integers(1, 4, snp.sum())) % 4
    return [write_fasta(tmp / "dA.fa", [("chr1", base)]),
            write_fasta(tmp / "dB.fa", [("chr1", mut)])]


@pytest.mark.parametrize("divergence", ["0.5", "1"])
def test_shipped_presets_default_w(tmp_path, default_pair, monkeypatch, divergence):
    """The shipped presets at the default k = 24, w = 1000: '< 1%'
    (w_rounds 100 10, test_default_params_e2e's) and '1% - 10%' (w_rounds
    250 100). The inversion is one '-' row of dB.fa near its ends."""
    j, t = _run_both(tmp_path, default_pair, monkeypatch, ["-d", divergence])
    _assert_same(j, t)
    rows = _rows(t["test.synteny_blocks.tsv"])
    inv = [r for r in rows if r[1] == "dB.fa" and r[5] == "-"]
    assert len(inv) == 1
    assert abs(int(inv[0][3]) - 800_000) < 3_000 and abs(int(inv[0][4]) - 1_200_000) < 3_000
    assert len({r[0] for r in rows}) == 3


def test_high_divergence_preset(tmp_path, monkeypatch):
    """The '> 10%' preset (-d 12: -b 10000 --indel 100000 --merge 1000000
    --w_rounds 500 250, BASELINE.json's high-divergence configuration) on
    a 3 Mbp pair with 2% substitutions, B inverted at 1.0-1.6 Mbp: the
    JAX run writes at least 3 blocks."""
    rng = np.random.default_rng(1212)
    base = rng.integers(0, 4, 3_000_000).astype(np.uint8)
    mut = mutate(rng, base, 0.02)
    mut[1_000_000:1_600_000] = mut[1_000_000:1_600_000][::-1] ^ 3
    fastas = [write_fasta(tmp_path / "hA.fa", [("chr1", base)]),
              write_fasta(tmp_path / "hB.fa", [("chr1", mut)])]
    j, t = _run_both(tmp_path, fastas, monkeypatch, ["-d", "12"])
    _assert_same(j, t)
    rows = _rows(j["test.synteny_blocks.tsv"])
    assert len({r[0] for r in rows}) >= 3
    assert any(r[1] == "hB.fa" and r[5] == "-" for r in rows)
