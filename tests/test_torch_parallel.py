"""The port's mesh layer (ntsynt_tpu_torch/parallel/mesh.py) against the
JAX package's (ntsynt_tpu/parallel/mesh.py) on the CPU.

For each world size D in 1-4, D worker processes (tests/
torch_parallel_worker.py) join one gloo process group and run the port's
allreduce_or and _allreduce_dup, distributed_common_bf and
distributed_repeat_bf, sharded_sketch_genome (without filters, with the
common filter, with both, and on a genome of short contigs only) and the
three step functions on inputs made here from a seed with numpy. Each
rank's results must equal, bit for bit, the JAX function's on a D-device
mesh of the virtual CPU devices (tests/conftest.py), and the port's
single-device filter builds and sketch. Tolerance 0 throughout."""

import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from ntsynt_tpu.io.fasta import read_fasta as j_read_fasta
from ntsynt_tpu.ops import bf_build as j_bf_build
from ntsynt_tpu.ops.bloom import load_bf as j_load_bf
from ntsynt_tpu.parallel import mesh as j_mesh
from ntsynt_tpu_torch.io.fasta import read_fasta
from ntsynt_tpu_torch.ops import bf_build, sketch
from ntsynt_tpu_torch.ops.bloom import BloomFilter, load_bf
from ntsynt_tpu_torch.parallel import mesh as pmesh

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
WORLDS = (1, 2, 3, 4)
DEC = np.array(list("ACGTN"))
K, W, CHUNK, BITS = 24, 50, 512, 16  # the step functions' shape
N_TILES = 12  # divisible by every world size


def _write(path, contigs):
    with open(path, "w") as f:
        for name, codes in contigs:
            f.write(f">{name}\n")
            s = "".join(DEC[codes])
            f.write("\n".join(s[i : i + 60] for i in range(0, len(s), 60)) + "\n")
    return str(path)


def _halves(codes):
    h = len(codes) // 2
    return [("c1", codes[:h]), ("c2", codes[h:])]


def _sketch_contigs(rng):
    """Contigs with scattered Ns, two short contigs (fewer than w k-mers)
    and lengths that put contig 2's start exactly on the two-rank slab
    boundary of the k=24, w=60 stream: with separators of w + k = 84
    codes the windows number sum(L) + 5 * 84 - 82 = 54,336, and contig 2
    starts at 20,000 + 7,000 + 2 * 84 = 27,168. A run of N codes
    straddles the three-rank boundary (window 18,112)."""
    c0 = rng.integers(0, 4, 20_000).astype(np.uint8)
    c0[rng.random(len(c0)) < 0.001] = 4
    c0[18_000:18_300] = 4
    c1 = rng.integers(0, 4, 7_000).astype(np.uint8)
    c1[3_000:3_500] = c0[1_000:1_500]  # a repeat
    shorts = [rng.integers(0, 4, n).astype(np.uint8) for n in (50, 30)]
    c2 = rng.integers(0, 4, 54_336 - 338 - 27_000 - 80).astype(np.uint8)
    c2[100:700] = c1[2_000:2_600]
    return [("c0", c0), ("c1", c1), ("c2", c2), ("s3", shorts[0]), ("s4", shorts[1])]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_parallel")
    rng = np.random.default_rng(9)  # the common pair (tests/test_parallel.py)
    a = rng.integers(0, 4, 9_000).astype(np.uint8)
    b = a.copy()
    b[::211] = (b[::211] + 2) % 4
    _write(d / "ca.fa", _halves(a))
    _write(d / "cb.fa", _halves(b))
    rng = np.random.default_rng(17)  # repeats spanning slab boundaries
    r = rng.integers(0, 4, 12_000).astype(np.uint8)
    for src, dst in [(1_000, 9_500), (3_100, 11_000), (5_200, 200)]:
        r[dst : dst + 200] = r[src : src + 200]
    _write(d / "r.fa", _halves(r))
    rng = np.random.default_rng(11)
    contigs = _sketch_contigs(rng)
    _write(d / "s.fa", contigs)
    mutated = [(n, c.copy()) for n, c in contigs]
    for _, c in mutated:
        snp = rng.random(len(c)) < 0.01
        c[snp] = (c[snp] + 1) % 4
    _write(d / "s2.fa", mutated)
    _write(d / "t.fa", [("t0", rng.integers(0, 4, 70).astype(np.uint8)),
                        ("t1", rng.integers(0, 4, 40).astype(np.uint8))])
    # the sketch's filters, built by the JAX package and saved in the
    # native container both packages load
    jg = [j_read_fasta(str(d / n)) for n in ("s.fa", "s2.fa")]
    for name, bf in (("s_common", j_bf_build.build_common_bf(jg, 24)),
                     ("s_repeat", j_bf_build.build_repeat_bf(jg[:1], 24, chunk=1 << 12))):
        BloomFilter.from_u32(np.asarray(bf.words), bf.num_bits, 24, device="cpu").save(
            str(d / f"{name}.bf"))
    # allreduce inputs: one row of 1,001 words (no multiple of 2, 3 or 4)
    # per rank, about one bit in eight set
    words = np.bitwise_and.reduce(rng.integers(0, 1 << 32, (3, 4, 1001), dtype=np.uint64), 0)
    g1 = rng.integers(0, 4, N_TILES * CHUNK + W + K).astype(np.uint8)
    g2 = g1.copy()
    g2[::500] = (g2[::500] + 1) % 4
    g1[700:760] = 4
    np.savez(d / "inputs.npz", or_words=words.astype(np.uint32).view(np.int32),
             tiles=j_mesh.make_tiles(g1, N_TILES, CHUNK, K, W),
             tiles_g2=j_mesh.make_tiles(g2, N_TILES, CHUNK, K, 1),
             step_kwcb=np.array([K, W, CHUNK, BITS]))
    return d


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _launch(world, data, out):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    port = _free_port()
    return [subprocess.Popen([sys.executable, os.path.join(HERE, "torch_parallel_worker.py"),
                              str(r), str(world), str(port), str(data), str(out)],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env)
            for r in range(world)]


def _finish(procs, timeout=240):
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=timeout)[0].decode(errors="replace"))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    return outs


@pytest.fixture(scope="module")
def ranks(data, tmp_path_factory):
    """{D: [rank r's results]}: every world size's group runs at once,
    each on its own free port (a group whose port was taken meanwhile is
    started once more)."""
    outdirs = {w: tmp_path_factory.mktemp(f"world{w}") for w in WORLDS}
    groups = {w: _launch(w, data, outdirs[w]) for w in WORLDS}
    results = {}
    for w, procs in groups.items():
        outs = _finish(procs)
        if any(p.returncode for p in procs) and any("ddress already in use" in o for o in outs):
            procs = _launch(w, data, outdirs[w])
            outs = _finish(procs)
        for r, (p, out) in enumerate(zip(procs, outs)):
            assert p.returncode == 0 and f"WORKER_OK rank={r}" in out, out[-4000:]
        results[w] = [dict(np.load(outdirs[w] / f"rank{r}.npz")) for r in range(w)]
    return results


def _u32(a):
    return np.asarray(a).view(np.uint32)


def _same_on_every_rank(ranks, world, key):
    got = [res[key] for res in ranks[world]]
    for g in got[1:]:
        assert np.array_equal(g, got[0]), f"{key}: ranks disagree"
    return got[0]


def _shard_map(world, fn, out_specs):
    return jax.jit(jax.shard_map(fn, mesh=j_mesh.make_mesh(world), in_specs=P(j_mesh.AXIS),
                                 out_specs=out_specs, check_vma=False))


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("world", WORLDS)
def test_allreduce_or(ranks, data, world):
    x = _u32(np.load(data / "inputs.npz")["or_words"][:world])
    want = np.asarray(_shard_map(world, lambda v: j_mesh.allreduce_or(v[0]), P())(x))
    assert np.array_equal(want, np.bitwise_or.reduce(x, axis=0))
    assert np.array_equal(_u32(_same_on_every_rank(ranks, world, "or")), want)


@pytest.mark.parametrize("world", WORLDS)
def test_allreduce_dup(ranks, data, world):
    x = _u32(np.load(data / "inputs.npz")["or_words"][:world])
    once, twice = _shard_map(world, lambda v: j_mesh._allreduce_dup(v[0]), (P(), P()))(x)
    bits = np.unpackbits(x.view(np.uint8), axis=1).astype(int).sum(0)
    assert np.array_equal(np.unpackbits(np.asarray(twice).view(np.uint8)), bits >= 2)
    assert np.array_equal(_u32(_same_on_every_rank(ranks, world, "dup_once")), np.asarray(once))
    assert np.array_equal(_u32(_same_on_every_rank(ranks, world, "dup_twice")), np.asarray(twice))


@pytest.mark.parametrize("world", WORLDS)
def test_broadcast_from_rank0(ranks, data, world):
    """broadcast_object and broadcast_bf give every rank rank 0's value:
    an array, a device filter's words (its .bf read on rank 0 only) and a
    host filter of a bit count that is no power of two."""
    assert np.array_equal(_same_on_every_rank(ranks, world, "bcast_obj"), np.arange(5) * 7)
    want = load_bf(str(data / "s_common.bf"), device="cpu").words.numpy()
    assert np.array_equal(_same_on_every_rank(ranks, world, "bcast_words"), want)
    host = np.load(data / "inputs.npz")["or_words"][0].view(np.uint8)
    assert np.array_equal(_same_on_every_rank(ranks, world, "bcast_host_bits"), host)


# ---------------------------------------------------------------------------
# Bloom filters
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def common_single(data):
    genomes = [read_fasta(str(data / n)) for n in ("ca.fa", "cb.fa")]
    return bf_build.build_common_bf(genomes, 20, fpr=0.025, device="cpu").words.numpy()


@pytest.mark.parametrize("world", WORLDS)
def test_distributed_common_bf(ranks, data, common_single, world):
    """Words equal to JAX distributed_common_bf on a D-device mesh and to
    the port's single-device cascade."""
    jg = [j_read_fasta(str(data / n)) for n in ("cb.fa", "ca.fa")]
    want = np.asarray(j_mesh.distributed_common_bf(jg, 20, fpr=0.025,
                                                   mesh=j_mesh.make_mesh(world),
                                                   seg_max=1 << 9).words)
    got = _same_on_every_rank(ranks, world, "common")
    assert np.array_equal(_u32(got), want)
    assert np.array_equal(got, common_single)
    assert 0 < np.unpackbits(want.view(np.uint8)).sum() < len(want) * 32


@pytest.mark.parametrize("world", WORLDS)
def test_distributed_repeat_bf(ranks, data, world):
    """Words equal to JAX distributed_repeat_bf on a D-device mesh with the
    same seg_max (the segment boundaries are part of the result), at D=4
    with a rank whose slab lies past the genome."""
    jg = [j_read_fasta(str(data / "r.fa"))]
    want = np.asarray(j_mesh.distributed_repeat_bf(jg, 20, mesh=j_mesh.make_mesh(world),
                                                   seg_max=1 << 9).words)
    assert np.array_equal(_u32(_same_on_every_rank(ranks, world, "repeat")), want)
    assert np.unpackbits(want.view(np.uint8)).sum() >= 3 * (200 - 20 + 1) * 0.9
    if world == 4:
        stream = sketch._Stream(read_fasta(str(data / "r.fa")), 20, 1)
        seg, slab = pmesh.repeat_geometry(stream.total - 20 + 1, 4, 1 << 9)
        assert 3 * slab > stream.total - 20 + 1  # rank 3 had no k-mer


def test_distributed_repeat_bf_matches_single(ranks, data):
    """With the segment at seg_max, the two-rank filter equals the port's
    single-device walk (tests/test_parallel.py::
    test_distributed_repeat_bf_matches_single)."""
    single = bf_build.build_repeat_bf([read_fasta(str(data / "r.fa"))], 20, chunk=1 << 9,
                                      device="cpu")
    assert np.array_equal(_same_on_every_rank(ranks, 2, "repeat"), single.words.numpy())


# ---------------------------------------------------------------------------
# sketch
# ---------------------------------------------------------------------------

FILTERS = ("none", "common", "both")


@pytest.fixture(scope="module")
def filters(data):
    return {"jax": (j_load_bf(str(data / "s_common.bf")), j_load_bf(str(data / "s_repeat.bf"))),
            "torch": (load_bf(str(data / "s_common.bf"), device="cpu"),
                      load_bf(str(data / "s_repeat.bf"), device="cpu"))}


def _pick(pair, name):
    return {"none": (None, None), "common": (pair[0], None), "both": pair}[name]


@pytest.mark.parametrize("world,name", [(1, "none"), (2, "none"), (2, "common"), (2, "both"),
                                        (3, "none"), (3, "common"), (3, "both"), (4, "both")])
def test_sharded_sketch_genome(ranks, data, filters, world, name):
    """Positions, contigs and hashes equal to JAX sharded_sketch_genome on
    a D-device mesh and to the port's single-device sketch_genome (at
    D=2 contig 2 starts on the slab boundary)."""
    jc, jr = _pick(filters["jax"], name)
    want = j_mesh.sharded_sketch_genome(j_read_fasta(str(data / "s.fa")), 24, 60,
                                        mesh=j_mesh.make_mesh(world), seg_max=1 << 10,
                                        common_bf=jc, repeat_bf=jr)
    tc, tr = _pick(filters["torch"], name)
    single = sketch.sketch_genome(read_fasta(str(data / "s.fa")), 24, 60, common_bf=tc,
                                  repeat_bf=tr, device="cpu")
    for field, ref in (("ctg", "contig_idx"), ("pos", "positions"), ("hash", "hashes"),
                       ("canon", "canon")):
        got = _same_on_every_rank(ranks, world, f"sk_{name}_{field}")
        assert np.array_equal(got, getattr(want, ref)), field
        assert np.array_equal(got, getattr(single, ref)), field
    assert set(want.contig_idx.tolist()) >= {0, 1, 2} and len(want.positions) > 500
    if name == "none":
        assert {3, 4} <= set(want.contig_idx.tolist())  # the short contigs' fallback


@pytest.mark.parametrize("world", (2, 4))
def test_sharded_sketch_short_contigs_only(ranks, data, world):
    """No rank has a legit window: only the short-contig fallback selects."""
    want = j_mesh.sharded_sketch_genome(j_read_fasta(str(data / "t.fa")), 24, 60,
                                        mesh=j_mesh.make_mesh(world))
    assert len(want.positions) == 2
    for field, ref in (("ctg", "contig_idx"), ("pos", "positions"), ("hash", "hashes")):
        assert np.array_equal(_same_on_every_rank(ranks, world, f"sk_tiny_{field}"),
                              getattr(want, ref)), field


# ---------------------------------------------------------------------------
# the step functions
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_steps(data):
    """{D: the JAX step functions' outputs on a D-device mesh}."""
    inp = np.load(data / "inputs.npz")
    tiles, t2 = (jnp.asarray(inp[n]) for n in ("tiles", "tiles_g2"))
    zeros = jnp.zeros((1 << BITS) // 32, jnp.uint32)
    out = {}
    for world in (1, 2, 3):
        mesh = j_mesh.make_mesh(world)
        arg, valid, words = j_mesh.sharded_sketch_step(mesh, K, W, CHUNK, BITS)(tiles, zeros)
        # the cascade: the k-mers of g2 that the sketch step's filter holds
        probe = j_mesh.sharded_common_bf_probe_step(mesh, K, CHUNK, BITS)(t2, words, zeros)
        farg, fvalid = j_mesh.sharded_filtered_sketch_step(mesh, K, W, CHUNK, BITS, BITS)(
            tiles, words, probe)
        out[world] = {k: np.asarray(v) for k, v in dict(
            step_arg=arg, step_valid=valid, step_words=words, probe_words=probe,
            filtered_arg=farg, filtered_valid=fvalid).items()}
    return out


@pytest.mark.parametrize("world", (1, 2, 3))
@pytest.mark.parametrize("step", ("sketch", "probe", "filtered"))
def test_step_functions(ranks, jax_steps, world, step):
    """Each rank's rows of the argmins and window validity stacked in rank
    order, and the OR-reduced words, equal the JAX step's."""
    want = jax_steps[world]
    keys = {"sketch": ("step_arg", "step_valid", "step_words"), "probe": ("probe_words",),
            "filtered": ("filtered_arg", "filtered_valid")}[step]
    for key in keys:
        if key.endswith("words"):
            assert np.array_equal(_u32(_same_on_every_rank(ranks, world, key)), want[key]), key
        else:
            got = np.concatenate([res[key] for res in ranks[world]])
            assert np.array_equal(got, want[key].astype(got.dtype)), key
    if step == "filtered":  # the filters removed some windows' candidates
        assert 0 < want["filtered_valid"].sum() < want["step_valid"].sum()


def test_make_tiles():
    rng = np.random.default_rng(2)
    codes = rng.integers(0, 5, 3_000).astype(np.uint8)
    for n_tiles, chunk, w in ((5, 512, 50), (7, 400, 1)):
        assert np.array_equal(pmesh.make_tiles(codes, n_tiles, chunk, K, w),
                              j_mesh.make_tiles(codes, n_tiles, chunk, K, w))


def test_make_mesh_without_a_group():
    """No process group: a world of one rank on the given device, which
    runs no collective; asking for more devices raises."""
    import torch

    mesh = pmesh.make_mesh(device="cpu")
    assert (mesh.group, mesh.rank, mesh.size, mesh.device) == (None, 0, 1, torch.device("cpu"))
    x = torch.arange(5, dtype=torch.int32)
    assert pmesh.allreduce_or(x, mesh) is x
    with pytest.raises(ValueError, match="one device each"):
        pmesh.make_mesh(2, device="cpu")
