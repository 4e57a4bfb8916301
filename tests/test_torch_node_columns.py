"""The graph's node columns against the hash joins they replace.

Host synteny reads each node's contig and position in every assembly
from the graph (MinimizerGraph.node_ctg / node_pos) instead of joining
hashes against each assembly's mx_info. These tests hold the columns to
that join, kept beside the run as the JAX package's MxInfo with
update_list_mx_info's merges (the new value wins): at every pass and
refinement round of CLI runs at N = 2 and N = 4, fresh and resumed from
the sketch TSVs; and case by case on small graphs: a round whose new
minimizers include existing nodes, a node deleted and re-added in a
round, the deletions carrying the columns, and the erosion walk's
positions.
"""

import numpy as np
import pytest

from ntsynt_tpu.core.assembly import MxInfo as JaxMxInfo
from ntsynt_tpu.core.assembly import AssemblyMinimizers as JaxAssembly
from ntsynt_tpu.core.synteny import SyntenyDetector as JaxDetector
from ntsynt_tpu.core.synteny import SyntenyParams as JaxParams
from ntsynt_tpu_torch.cli import main as torch_main
from ntsynt_tpu_torch.core import synteny
from ntsynt_tpu_torch.core.assembly import AssemblyMinimizers
from ntsynt_tpu_torch.graph.mxgraph import MinimizerGraph
from tests.test_torch_published_shapes import mutate, write_fasta


class _Shadow:
    """Each assembly's mx_info as the hash-join code kept it: the initial
    index, merged with every round's kept minimizers, the new value
    winning. Checks a graph's columns, and blocks' positions, against it."""

    def __init__(self):
        self.info = None
        self.checks = 0
        self.events = {"overwritten": 0, "readded": 0, "deleted": 0, "broken": 0}
        self.deleted = set()

    def start(self, det):
        self.info = {k: JaxMxInfo(a.mx_info.sorted_hash, a.mx_info.ctg, a.mx_info.pos)
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

    def merge(self, det, segments, new_info):
        nodes = set(det.graph.node_hash.tolist())
        for key in det.files:
            kept = (np.unique(np.concatenate(segments[key])) if segments[key]
                    else np.zeros(0, np.uint64))
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
            new_info[key] = asm.mx_info
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


def _first(lists):
    """The first graph: one list per contig per assembly, with positions."""
    adj, cols = [], []
    for a, ls in enumerate(lists):
        adj.append((f"a{a}", [np.asarray(x, np.uint64) for x, _ in ls]))
        cols.append((np.concatenate([np.full(len(x), ci, np.int32) for ci, (x, _) in enumerate(ls)]),
                     np.concatenate([np.asarray(y, np.int64) for _, y in ls])))
    return MinimizerGraph.build(adj, {k: 1 for k, _ in adj}, columns=cols)


def _round(seed, segments, black_list=()):
    """A round's graph: per assembly (segment lists, ctg, pos) of its kept
    minimizers."""
    adj = [(f"a{a}", [np.asarray(s, np.uint64) for s in segs]) for a, (segs, _, _) in
           enumerate(segments)]
    cols = [(np.asarray(c, np.int32), np.asarray(p, np.int64)) for _, c, p in segments]
    return MinimizerGraph.build(adj, {k: 1 for k, _ in adj}, seed=seed,
                                black_list=np.asarray(black_list, np.uint64), columns=cols)


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
