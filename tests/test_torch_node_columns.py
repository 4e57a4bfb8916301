"""The graph's node columns against the hash joins they replace.

Host synteny reads each node's contig and position in every assembly
from the graph (MinimizerGraph.node_ctg / node_pos), filled from the
assemblies' and each round's minimizer tables, instead of joining
hashes against an index of each assembly. These tests hold the columns
to that join, kept beside the run as the JAX package's MxInfo with
update_list_mx_info's merges (the new value wins): at every pass and
refinement round of CLI runs at N = 2 and N = 4, fresh and resumed from
the sketch TSVs; and case by case on small graphs: a round whose new
minimizers include existing nodes, a node deleted and re-added in a
round, the deletions carrying the columns, and the erosion walk's
positions. The one common filter of the tables is held to the JAX
package's two, over the first lists and over a round's segments.
"""

import numpy as np
import pytest

from ntsynt_tpu.core.assembly import MxInfo as JaxMxInfo
from ntsynt_tpu.core.assembly import AssemblyMinimizers as JaxAssembly
from ntsynt_tpu.core.assembly import filter_common as jax_filter_common
from ntsynt_tpu.core.assembly import filter_segments_common as jax_filter_segments_common
from ntsynt_tpu.core.synteny import SyntenyDetector as JaxDetector
from ntsynt_tpu.core.synteny import SyntenyParams as JaxParams
from ntsynt_tpu_torch.cli import main as torch_main
from ntsynt_tpu_torch.core import synteny
from ntsynt_tpu_torch.core.assembly import AssemblyMinimizers, filter_common
from ntsynt_tpu_torch.graph.mxgraph import MinimizerGraph
from tests.test_torch_published_shapes import mutate, write_fasta


class _Shadow:
    """Each assembly's index as the hash-join code kept it: built from
    the assembly's table, merged with every round's kept minimizers, the
    new value winning. Checks a graph's columns, and blocks' positions,
    against it."""

    def __init__(self):
        self.info = None
        self.checks = 0
        self.events = {"overwritten": 0, "readded": 0, "deleted": 0, "broken": 0}
        self.deleted = set()

    def start(self, det):
        self.info = {k: JaxMxInfo.from_arrays(a.hashes, a.ctg, a.pos)
                     for k, a in det.assemblies.items()}

    def check_graph(self, det):
        g = det.graph
        assert g.node_ctg.shape == g.node_pos.shape == (len(det.files), g.n_nodes)
        for a, key in enumerate(det.files):
            c, p = self.info[key].lookup(g.node_hash)
            np.testing.assert_array_equal(g.node_ctg[a], c)
            np.testing.assert_array_equal(g.node_pos[a], p)
        self.checks += 1

    def check_blocks(self, det, blocks):
        for b in blocks:
            for a, key in enumerate(det.files):
                c, p = self.info[key].lookup(b.mx)
                np.testing.assert_array_equal(b.pos[a], p)
                assert (c == b.ctg[a]).all()
        self.checks += 1

    def merge(self, det, tables, new_info):
        nodes = set(det.graph.node_hash.tolist())
        for key, (hashes, _, _, _) in zip(det.files, tables):
            kept = np.unique(hashes)
            c, p = new_info[key].lookup(kept)
            self.info[key] = self.info[key].update(kept, c, p)
            self.events["overwritten"] += len(nodes.intersection(kept.tolist()))
            self.events["readded"] += len(self.deleted.intersection(kept.tolist()))


@pytest.fixture
def shadowed(monkeypatch):
    """Runs of the port checked against _Shadow at every graph it makes."""
    shadow = _Shadow()
    D = synteny.SyntenyDetector
    init, make, extract, erode, more = (
        D.__init__, D.make_minimizer_graph, D.extract_blocks, D.refine_graph_erosion,
        D.generate_additional_minimizers)
    indels = synteny.blk.check_for_indels
    new_info = {}

    class Recording(AssemblyMinimizers):
        @classmethod
        def from_arrays(cls, key, *args, **kw):
            asm = AssemblyMinimizers.from_arrays(key, *args, **kw)
            new_info[key] = JaxMxInfo.from_arrays(asm.hashes, asm.ctg, asm.pos)
            return asm

    def __init__(self, assemblies, params):
        init(self, assemblies, params)
        shadow.start(self)

    def make_graph(self):
        make(self)
        shadow.check_graph(self)

    def extract_blocks(self, suffix=""):
        shadow.check_graph(self)
        before = set(self.graph.node_hash.tolist())
        blocks = extract(self, suffix)
        gone = before - set(self.graph.node_hash.tolist())
        shadow.events["deleted"] += len(gone)
        shadow.deleted |= gone
        shadow.check_graph(self)
        shadow.check_blocks(self, blocks)
        return blocks

    def check_for_indels(blocks, bp):
        out, broken = indels(blocks, bp)
        shadow.events["broken"] += len(broken[0])
        return out, broken

    def refine_graph_erosion(self, pairs, suffix=""):
        shadow.check_graph(self)
        erode(self, pairs, suffix)

    def generate(self, blocks, new_w, prev_w):
        out = more(self, blocks, new_w, prev_w)
        shadow.merge(self, out[0], new_info)
        return out

    monkeypatch.setattr(synteny, "AssemblyMinimizers", Recording)
    monkeypatch.setattr(synteny.blk, "check_for_indels", check_for_indels)
    monkeypatch.setattr(D, "__init__", __init__)
    monkeypatch.setattr(D, "make_minimizer_graph", make_graph)
    monkeypatch.setattr(D, "extract_blocks", extract_blocks)
    monkeypatch.setattr(D, "refine_graph_erosion", refine_graph_erosion)
    monkeypatch.setattr(D, "generate_additional_minimizers", generate)
    return shadow


def _genomes(tmp_path, n):
    """n genomes of two contigs, a star from genome 0 at 1% SNPs; genome
    1 inverted in contig 1, with 400 bp pieces of the two contigs swapped
    (paths too short to keep) and 2 kb inserted in contig 2; the last
    genome's contig 2 shortened (a contig end)."""
    rng = np.random.default_rng(20 + n)
    base = [rng.integers(0, 4, 150_000).astype(np.uint8) for _ in range(2)]
    paths = []
    for gi in range(n):
        c1, c2 = (base if gi == 0 else [mutate(rng, c, 0.01) for c in base])
        if gi == 1:
            c1[40_000:90_000] = 3 - c1[40_000:90_000][::-1]
            for at in (110_000, 125_000, 140_000):
                c1[at:at + 400], c2[at:at + 400] = c2[at:at + 400].copy(), c1[at:at + 400].copy()
            c2 = np.concatenate([c2[:70_000], rng.integers(0, 4, 2_000).astype(np.uint8),
                                 c2[70_000:]])
        if gi == n - 1 and n > 2:
            c2 = c2[:120_000]
        paths.append(write_fasta(tmp_path / f"g{gi}.fa", [("c1", c1), ("c2", c2)]))
    return paths


@pytest.mark.parametrize("n, resumed", [(2, False), (2, True), (4, False), (4, True)],
                         ids=["n2", "n2-resumed", "n4", "n4-resumed"])
def test_columns_equal_the_hash_join_at_every_pass(tmp_path, monkeypatch, shadowed, n, resumed):
    paths = _genomes(tmp_path, n)
    monkeypatch.chdir(tmp_path)
    args = [*paths, "-d", "1", "-w", "250", "--indel", "1000", "--device", "cpu", "-p", "t"]
    if resumed:  # the second run reads every assembly from its sketch TSV
        assert torch_main(args) == 0
        shadowed.checks = 0
        shadowed.events = dict.fromkeys(shadowed.events, 0)
    assert torch_main(args) == 0
    # the first graph, three passes (before, blocks, after) and the last
    # round's erosion
    assert shadowed.checks == 1 + 3 * 3 + 1
    # every round's new minimizers hold existing nodes (blocks' terminals,
    # re-selected at the smaller w): their columns are overwritten; the
    # swapped pieces' short paths lose their nodes, which a later round
    # adds again; the insertion breaks blocks, whose edges go by node id
    assert shadowed.events["overwritten"] > 0
    assert shadowed.events["deleted"] > 0
    assert shadowed.events["readded"] > 0
    assert shadowed.events["broken"] > 0


# ---------------------------------------------------------------------------
# case by case, on small graphs
# ---------------------------------------------------------------------------


def _oracle(lists, rounds=()):
    """JAX MxInfo per assembly over the first lists, merged with each
    round's (hashes, ctg, pos)."""
    infos = []
    for a, ls in enumerate(lists):
        h = np.concatenate([np.asarray(x, np.uint64) for x, _ in ls])
        c = np.concatenate([np.full(len(x), ci, np.int32) for ci, (x, _) in enumerate(ls)])
        p = np.concatenate([np.asarray(y, np.int64) for _, y in ls])
        info = JaxMxInfo.from_arrays(h, c, p)
        for r in rounds:
            rh, rc, rp = (np.asarray(v, t) for v, t in zip(r[a], (np.uint64, np.int32, np.int64)))
            info = info.update(rh, rc, rp)
        infos.append(info)
    return infos


def _runs(lists):
    """(hashes, run id) of lists laid end to end, a list a run."""
    run = np.repeat(np.arange(len(lists), dtype=np.int32), [len(x) for x in lists])
    return np.concatenate([np.asarray(x, np.uint64) for x in lists]), run


def _first(lists):
    """The first graph: one list per contig per assembly, with positions;
    each assembly's table has the contig as its run."""
    tables = []
    for ls in lists:
        h, ctg = _runs([x for x, _ in ls])
        tables.append((h, ctg, np.concatenate([np.asarray(y, np.int64) for _, y in ls]), ctg))
    return MinimizerGraph.build(tables)


def _round(seed, segments, black_list=()):
    """A round's graph: per assembly (segment lists, ctg, pos) of its kept
    minimizers; each table has the segment as its run."""
    tables = []
    for segs, c, p in segments:
        h, run = _runs(segs)
        tables.append((h, np.asarray(c, np.int32), np.asarray(p, np.int64), run))
    return MinimizerGraph.build(tables, seed=seed, black_list=np.asarray(black_list, np.uint64))


def _assert_columns(g, infos):
    for a, info in enumerate(infos):
        c, p = info.lookup(g.node_hash)
        np.testing.assert_array_equal(g.node_ctg[a], c)
        np.testing.assert_array_equal(g.node_pos[a], p)


# two assemblies, three contigs in the first and two in the second
FIRST = [
    [([11, 12, 13, 14], [100, 200, 300, 400]), ([15, 16], [50, 90]), ([], [])],
    [([16, 15, 14], [900, 800, 700]), ([13, 12, 11], [30, 20, 10])],
]


def _case(name):
    """(graph, oracle) after the case's operations."""
    g = _first(FIRST)
    if name == "first_graph":
        return g, _oracle(FIRST)
    if name == "new_value_wins":
        # node 13 re-selected at other positions, 21 new, between 12 and 13
        rnd = [([[12, 21, 13]], [0, 0, 0], [200, 250, 310]),
               ([[13, 21, 12]], [1, 1, 1], [31, 25, 20])]
        r = [(h, c, p) for (segs, c, p) in rnd for h in [np.concatenate(segs)]]
        return _round(g, rnd, black_list=[12]), _oracle(FIRST, [r])
    if name == "deleted_then_readded":
        g = g.delete_nodes(np.flatnonzero(np.isin(g.node_hash, [14, 16])))
        assert not np.isin([14, 16], g.node_hash).any()
        rnd = [([[14]], [0], [444]), ([[14]], [0], [777])]
        r = [(h, c, p) for (segs, c, p) in rnd for h in [np.concatenate(segs)]]
        g = _round(g, rnd)
        assert 14 in g.node_hash and 16 not in g.node_hash
        return g, _oracle(FIRST, [r])
    assert name == "carried_through_deletes"
    g = g.filter_global(2).delete_edges([0]).simplify_bubbles(2)
    g = g.delete_nodes([1, g.n_nodes - 1])
    return g, _oracle(FIRST)


@pytest.mark.parametrize("name", ["first_graph", "new_value_wins", "deleted_then_readded",
                                  "carried_through_deletes"])
def test_columns_case(name):
    g, oracle = _case(name)
    _assert_columns(g, oracle)


def _erosion_assemblies(module):
    """Two assemblies whose A list joins 3-4 (weight 1, flagged by the
    filter) with 2, 3, 4, 5 under k = 24 apart in A: the walk erodes."""
    a = module.from_arrays("a.fa", ["c1"], np.arange(1, 9, dtype=np.uint64),
                           np.zeros(8, np.int32),
                           np.asarray([0, 100, 110, 120, 130, 140, 400, 500], np.int64))
    b = module.from_arrays("b.fa", ["c1", "c2"], np.asarray([1, 2, 3, 4, 5, 6, 7, 8], np.uint64),
                           np.asarray([0, 0, 0, 1, 1, 1, 1, 1], np.int32),
                           np.asarray([0, 1000, 2000, 5000, 6000, 7000, 8000, 9000], np.int64))
    return {"a.fa": a, "b.fa": b}


def test_erosion_reads_positions_from_the_columns():
    """The last round's erosion walk on the port (node columns) and on the
    JAX package (mx_info joins) removes the same edges."""
    edges = {}
    for name, asm_cls, det_cls, params in (
            ("jax", JaxAssembly, JaxDetector, JaxParams),
            ("torch", AssemblyMinimizers, synteny.SyntenyDetector, synteny.SyntenyParams)):
        det = det_cls(_erosion_assemblies(asm_cls), params(k=24, w=100, n=2))
        det.make_minimizer_graph()
        flagged, pairs = det.graph.filter_global(2, flag=True)
        det.graph = flagged
        det.refine_graph_erosion(pairs)
        g = det.graph
        edges[name] = sorted(tuple(sorted((int(g.node_hash[u]), int(g.node_hash[v]))))
                             for u, v in zip(g.eu, g.ev))
    assert edges["torch"] == edges["jax"]
    assert len(edges["torch"]) < 6  # the walk removed edges


# ---------------------------------------------------------------------------
# the one common filter
# ---------------------------------------------------------------------------


def _tables(rng, n, parts):
    """n duplicate-free hash tables cut into ``parts`` runs: a shared pool
    each table draws most of its rows from in its own order, plus hashes
    of its own; table 0's second run is empty."""
    pool = rng.choice(1 << 62, 400, replace=False).astype(np.uint64)
    out = []
    for a in range(n):
        own = (np.uint64(1 << 62) + np.uint64(1000 * a)
               + np.arange(20, dtype=np.uint64))
        h = rng.permutation(np.concatenate([rng.choice(pool, 300, replace=False), own]))
        cuts = np.sort(rng.choice(np.arange(1, len(h)), parts - 1, replace=False))
        if a == 0:
            cuts[1] = cuts[0]
        run = np.repeat(np.arange(parts, dtype=np.int32), np.diff([0, *cuts, len(h)]))
        out.append((h, run))
    return out


@pytest.mark.parametrize("stage", ["first", "round"])
@pytest.mark.parametrize("n", [2, 3, 4])
def test_one_common_filter_keeps_the_jax_filters_rows(n, stage):
    """filter_common's masks keep, in order, the rows the JAX package's
    filter_common keeps of each assembly's contig lists (an empty contig
    among them) and its filter_segments_common keeps of a round's
    segments (an empty segment among them)."""
    rng = np.random.default_rng(40 + n)
    tables = _tables(rng, n, 4)
    masks = filter_common([h for h, _ in tables])
    if stage == "first":
        asms = {}
        for a, (h, run) in enumerate(tables):
            pos = np.arange(len(h), dtype=np.int64) * 10
            asms[f"g{a}.fa"] = JaxAssembly.from_arrays(
                f"g{a}.fa", [f"c{i}" for i in range(4)], h, run, pos)
        jax_filter_common(asms)
        kept = [asms[f"g{a}.fa"].lists for a in range(n)]
    else:
        segs = {a: [h[run == i] for i in range(4)] for a, (h, run) in enumerate(tables)}
        kept = list(jax_filter_segments_common(segs).values())
    assert 0 < masks[0].sum() < len(masks[0])
    for (h, run), keep, lists in zip(tables, masks, kept):
        np.testing.assert_array_equal(h[keep], np.concatenate(lists))
        np.testing.assert_array_equal(np.bincount(run[keep], minlength=4),
                                      [len(x) for x in lists])
    assert len(kept[0][1]) == 0
