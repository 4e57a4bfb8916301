"""The mesh with multi-contig genomes and ``--filter Indexlr``: the port's
pipeline over D gloo ranks (one process each, running WORKER) against
the JAX package's over a D-device mesh of the virtual CPU devices, at
D = 2 and D = 3.

Each genome of the pair is five contigs of 900 kb, 4.5 x 10^6 k-mers of
the mesh's stream: its repeat walk runs in segments of 2^21 k-mers (the
JAX mesh's seg_max), two a slab at D = 2 and one at D = 3, so the genome
spans three segments and each rank's slab holds contig boundaries. The
mesh's stream puts k + 1 N codes between contigs where the single walk
puts k - 1, so the repeat filter follows the JAX mesh, not the
single-device run. Repeats are copied across contigs and across segment
ends. The .repeat.bf and .common.bf (byte-complete), the sketch TSVs
and the blocks must be byte-identical. Tolerance 0."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from ntsynt_tpu.core.pipeline import NtSyntTPU, PipelineConfig as JaxConfig
from ntsynt_tpu.parallel import mesh as j_mesh
from ntsynt_tpu_torch.ops.bloom import load_bf

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEC = np.array(list("ACGT"))
CONTIG, N_CONTIGS = 900_000, 5
KW = dict(k=24, w=100, w_rounds=(50, 10), block_size=500, indel=500, merge="3000",
          prefix="mc", repeat=True, repeat_filter="Indexlr", bf_artifact="full", use_mesh=True)
# one rank: python -c WORKER RANK WORLD PORT OUT_DIR FASTA...; the port's
# pipeline over the group from OUT_DIR (only rank 0 writes files)
WORKER = f"""
import sys
import torch
import torch.distributed as dist
from ntsynt_tpu_torch.core.pipeline import NtSyntPipeline, PipelineConfig
from ntsynt_tpu_torch.parallel import multihost

rank, world, port = (int(a) for a in sys.argv[1:4])
torch.set_num_threads(1)
assert multihost.initialize(f"localhost:{{port}}", world, rank, device="cpu") == "gloo"
try:
    NtSyntPipeline(PipelineConfig(fastas=sys.argv[5:], out_dir=sys.argv[4], device="cpu",
                                  **{KW!r})).run()
finally:
    dist.destroy_process_group()
print(f"WORKER_OK rank={{rank}}", flush=True)
"""
ARTIFACTS = ("mc.repeat.bf", "mc.common.bf", "ma.fa.k24.w100.tsv", "mb.fa.k24.w100.tsv",
             "mc.synteny_blocks.tsv")


def _write(path, contigs):
    with open(path, "w") as f:
        for name, codes in contigs:
            s = "".join(DEC[codes])
            f.write(f">{name}\n" + "\n".join(s[i : i + 70] for i in range(0, len(s), 70)) + "\n")
    return str(path)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """Genome A (five contigs, repeats copied across contigs and across
    the 2^21-k-mer segment ends) and B (A with 0.1% SNPs and a 60 kb
    inversion in contig 2)."""
    root = tmp_path_factory.mktemp("torch_mesh_contigs")
    rng = np.random.default_rng(4242)
    a = rng.integers(0, 4, CONTIG * N_CONTIGS).astype(np.uint8)
    for src, dst in ((100_000, 1_500_000), (2_090_000, 3_300_000), (4_190_000, 700_000),
                     (3_000_000, 2_096_000)):
        a[dst : dst + 15_000] = a[src : src + 15_000]
    b = a.copy()
    b[2_000_000:2_060_000] = b[2_000_000:2_060_000][::-1] ^ 3
    snp = rng.random(len(b)) < 0.001
    b[snp] = (b[snp] + rng.integers(1, 4, int(snp.sum()))) % 4
    return root, [_write(root / name, [(f"c{i}", g[i * CONTIG : (i + 1) * CONTIG])
                                       for i in range(N_CONTIGS)])
                  for name, g in (("ma.fa", a), ("mb.fa", b))]


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _files(d):
    return {f: open(os.path.join(d, f), "rb").read() for f in sorted(os.listdir(d))}


def _port_ranks(root, world, fastas):
    """Each rank's files from a world-rank gloo group running the port's
    pipeline (a group whose port was taken meanwhile is started once
    more)."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    dirs = [root / f"torch{world}_rank{r}" for r in range(world)]
    for _ in range(2):
        for d in dirs:
            d.mkdir(exist_ok=True)
        port = _free_port()
        procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(r), str(world), str(port),
                                   str(d), *fastas], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, env=env)
                 for r, d in enumerate(dirs)]
        outs = []
        for p in procs:
            try:
                outs.append(p.communicate(timeout=600)[0].decode(errors="replace"))
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                raise
        if all(p.returncode == 0 for p in procs) or not any(
                "ddress already in use" in o for o in outs):
            break
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"WORKER_OK rank={r}" in out, out[-4000:]
    return [_files(d) for d in dirs]


@pytest.fixture(scope="module", params=(2, 3), ids=("D2", "D3"))
def runs(request, pair):
    """{"jax": the JAX pipeline's files over a D-device mesh, "torch":
    rank 0's, "others": the other ranks'}."""
    world = request.param
    root, fastas = pair
    make_mesh = j_mesh.make_mesh
    j_mesh.make_mesh = lambda n_devices=None: make_mesh(n_devices or world)
    try:
        out = str(root / f"jax{world}")
        os.makedirs(out)
        NtSyntTPU(JaxConfig(fastas=fastas, out_dir=out, **KW)).run()
    finally:
        j_mesh.make_mesh = make_mesh
    ranks = _port_ranks(root, world, fastas)
    return {"jax": _files(out), "torch": ranks[0], "others": ranks[1:], "world": world}


@pytest.mark.parametrize("artifact", ARTIFACTS)
def test_mesh_contigs_filter_indexlr_matches_jax_mesh(runs, artifact):
    """Each artifact of rank 0 equals the JAX mesh's, byte for byte."""
    assert artifact in runs["torch"], sorted(runs["torch"])
    assert runs["torch"][artifact] == runs["jax"][artifact], f"{artifact} differs"


def test_mesh_contigs_artifact_sets_match(runs, tmp_path):
    """The same files, every one byte-identical; the other ranks write
    none; the inversion is a '-' block and the repeat filter is not
    empty."""
    assert sorted(runs["torch"]) == sorted(runs["jax"])
    for f, data in runs["jax"].items():
        assert runs["torch"][f] == data, f"{f} differs"
    assert all(files == {} for files in runs["others"])
    rows = [r.split("\t") for r in runs["torch"]["mc.synteny_blocks.tsv"].decode().splitlines()]
    assert any(r[5] == "-" and r[2] == "c2" for r in rows)
    path = os.path.join(str(tmp_path), "mc.repeat.bf")
    with open(path, "wb") as f:
        f.write(runs["torch"]["mc.repeat.bf"])
    assert load_bf(path, device="cpu").popcount() > 0
