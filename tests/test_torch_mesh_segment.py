"""The mesh's repeat-filter segment: ``--mesh --filter Indexlr`` of the
port against the JAX package's on a genome of more than 2^20 k-mers.

Both pipelines run in-process with use_mesh, the repeat filter in
Indexlr mode and byte-complete .bf artifacts: the JAX package over a
one-device mesh, the port with no process group (a world of one rank)
on the CPU. The mesh walk's segment is min(seg_max, next_pow2(n / D))
k-mers, and duplicates are found exactly within a segment but through
the seen filter's bits (collisions included) across segments, so the
segment is part of the result. The JAX pipeline keeps the mesh's
default seg_max of 2^21; past 2^20 k-mers a walk at 2^20 ends a segment
where the JAX walk does not, and its filter flags the seen-filter
collisions across that boundary as repeats. The .repeat.bf, the sketch
TSVs and the blocks must be byte-identical. Tolerance 0."""

import os

import numpy as np
import pytest

from ntsynt_tpu.core.pipeline import NtSyntTPU, PipelineConfig as JaxConfig
from ntsynt_tpu.parallel import mesh as j_mesh
from ntsynt_tpu_torch.core.pipeline import NtSyntPipeline, PipelineConfig

DEC = np.array(list("ACGT"))
LENGTH = 1_150_000  # one contig of 1,149,977 k-mers at k=24: past 2^20, within 2^21
KW = dict(k=24, w=100, w_rounds=(50, 10), block_size=500, indel=500, merge="3000",
          prefix="seg", repeat=True, repeat_filter="Indexlr", bf_artifact="full",
          use_mesh=True)


def _write(path, codes):
    with open(path, "w") as f:
        s = "".join(DEC[codes])
        f.write(">chr1\n" + "\n".join(s[i : i + 70] for i in range(0, len(s), 70)) + "\n")
    return str(path)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both pipelines' artifacts, {name: {file: bytes}}, on a pair with a
    repeat that straddles the 2^20-k-mer boundary and an inversion."""
    root = tmp_path_factory.mktemp("torch_mesh_segment")
    rng = np.random.default_rng(2111)
    a = rng.integers(0, 4, LENGTH).astype(np.uint8)
    a[1_040_000:1_060_000] = a[900_000:920_000]  # a repeat across the 2^20 boundary
    b = a.copy()
    b[300_000:360_000] = b[300_000:360_000][::-1] ^ 3
    snp = rng.random(LENGTH) < 0.001
    b[snp] = (b[snp] + rng.integers(1, 4, int(snp.sum()))) % 4
    fastas = [_write(root / "sa.fa", a), _write(root / "sb.fa", b)]
    make_mesh = j_mesh.make_mesh
    j_mesh.make_mesh = lambda n_devices=None: make_mesh(n_devices or 1)
    try:
        out = {}
        for name, cls, cfg in (
                ("jax", NtSyntTPU, JaxConfig(fastas=fastas, out_dir=str(root / "jax"), **KW)),
                ("torch", NtSyntPipeline, PipelineConfig(fastas=fastas, out_dir=str(root / "torch"),
                                                         device="cpu", **KW))):
            os.makedirs(cfg.out_dir)
            cls(cfg).run()
            out[name] = {f: open(os.path.join(cfg.out_dir, f), "rb").read()
                         for f in sorted(os.listdir(cfg.out_dir))}
    finally:
        j_mesh.make_mesh = make_mesh
    return out


@pytest.mark.parametrize("artifact", ["seg.repeat.bf", "sa.fa.k24.w100.tsv", "sb.fa.k24.w100.tsv",
                                      "seg.synteny_blocks.tsv"])
def test_mesh_filter_indexlr_matches_jax_mesh(runs, artifact):
    """Each artifact of the port's --mesh --filter Indexlr run equals the
    JAX package's, byte for byte."""
    assert artifact in runs["torch"], sorted(runs["torch"])
    assert runs["torch"][artifact] == runs["jax"][artifact], f"{artifact} differs"


def test_mesh_artifact_sets_match(runs):
    """The same files, every one byte-identical, and the inversion is a
    '-' block."""
    assert sorted(runs["torch"]) == sorted(runs["jax"])
    for f, data in runs["jax"].items():
        assert runs["torch"][f] == data, f"{f} differs"
    rows = [r.split("\t") for r in runs["torch"]["seg.synteny_blocks.tsv"].decode().splitlines()]
    assert any(r[5] == "-" for r in rows)
