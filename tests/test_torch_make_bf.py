"""The port's make-bf CLIs against the JAX package's on
tests/test_make_bf_cli.py's inputs: the same flags (``--bf``, ``--fpr``,
both ``--format`` containers) write byte-identical .bf files."""

import os

import numpy as np
import pytest
import torch

from ntsynt_tpu import make_bf as j_make_bf
from ntsynt_tpu_torch import make_bf
from ntsynt_tpu_torch.ops import bloom


@pytest.fixture(scope="module")
def make_bf_fastas(tmp_path_factory):
    """tests/test_make_bf_cli.py's inputs."""
    tmp = tmp_path_factory.mktemp("torch_make_bf")
    rng = np.random.default_rng(3)
    a = rng.integers(0, 4, 8_000).astype(np.uint8)
    b = a.copy()
    b[2_000:3_000] = rng.integers(0, 4, 1_000)
    a2 = np.concatenate([a, a[100:300]])
    dec = np.array(list("ACGT"))
    paths = []
    for name, codes in (("a.fa", a2), ("b.fa", b)):
        s = "".join(dec[codes])
        with open(tmp / name, "w", encoding="utf-8") as f:
            f.write(">chr1\n" + "\n".join(s[i : i + 70] for i in range(0, len(s), 70)) + "\n")
        paths.append(str(tmp / name))
    return paths


@pytest.mark.parametrize("tool,args,fmt", [
    ("common", [], "btllib"),
    ("common", [], "native"),
    ("common", ["--bf", "200000"], "btllib"),
    ("repeat", [], "btllib"),
    ("repeat", ["--bf", "64k"], "native"),
    ("repeat", ["--bf", "1M", "--fpr", "0.05"], "btllib"),
])
def test_make_bf_clis_match_jax(make_bf_fastas, tmp_path, monkeypatch, tool, args, fmt):
    fa, fb = make_bf_fastas
    genomes = ["--genome", fb, fa] if tool == "common" else ["--genome", fa, fb]
    argv = [*genomes, "-k", "24", "-p", "out", *args, "--format", fmt]
    for name, fn, more in (
        ("jax", getattr(j_make_bf, f"{tool}_main"), []),
        ("torch", getattr(make_bf, f"{tool}_main"), ["--device", "cpu"]),
    ):
        work = tmp_path / name
        work.mkdir()
        monkeypatch.chdir(work)
        assert fn(argv + more) == 0
    j_bytes = (tmp_path / "jax" / "out.bf").read_bytes()
    assert (tmp_path / "torch" / "out.bf").read_bytes() == j_bytes
    if fmt == "btllib":
        assert j_bytes.startswith(b"[BTLKmerBloomFilter_v6]")
    else:
        assert b'"magic": "ntsynt_tpu_bf1"' in j_bytes[:100]
    bf = bloom.load_bf(str(tmp_path / "torch" / "out.bf"), device="cpu")
    assert bf.k == 24 and bf.popcount() > 0


def test_make_bf_default_format_is_btllib_and_sizes_parse():
    for fn in (make_bf.common_main, make_bf.repeat_main):
        with pytest.raises(SystemExit):
            fn(["--genome", "x.fa", "-k", "24", "--format", "bogus", "--device", "cpu"])
    assert make_bf.parse_bf_size("64k") == j_make_bf.parse_bf_size("64k") == 64_000
    assert make_bf.parse_bf_size("2M") == 2_000_000
    with pytest.raises(Exception):
        make_bf.parse_bf_size("12q")
    if not torch.cuda.is_available():  # the default device is cuda: no quiet fallback
        with pytest.raises(RuntimeError, match="CUDA"):
            make_bf.repeat_main(["--genome", os.devnull, "-k", "24"])
