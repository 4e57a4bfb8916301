"""Multi-device scale-out over torch.distributed, one process per rank.

The torch counterpart of the JAX package's mesh layer
(ntsynt_tpu/parallel/mesh.py). A genome's code stream is cut into one
contiguous slab per rank, and the only global state, the Bloom-filter
words and the minimizer selections, is combined with collectives:

  * each rank packs and uploads only its own slab of the stream, with
    the halo its last k-mers or windows need, in the single-device
    path's wire format (ops/sketch.PackedUpload: planar 2-bit codes and
    an N bitmap, 0.375 bytes a code, unpacked on the card), as the JAX
    mesh's ``_pack_rows``/``_unpack_row`` do; the sketch's legit mask
    goes up as the bytes of the rank's share of the stream's legit bits,
    with the share's bit offset;
  * per rank, the slab goes through the kernels of the single-device
    path: K1 and K4 for the common filter, on each group of the slab as
    it lands; K1, a probe,
    ``first_occurrence`` and K4 for the repeat walk; K1, the probes, K2
    and K3 for the sketch;
  * Bloom-filter words are combined by a bitwise-OR all-reduce. Neither
    NCCL nor gloo reduces with OR, so ``allreduce_or`` is an
    ``all_to_all_single`` of D chunks, an OR of the D chunks each rank
    receives, and an all-gather of the ORed chunks: about twice the
    filter in memory at any D, where an all-gather of whole filters
    needs D copies;
  * selections are gathered to every rank (the counts, then padded int64
    positions and hashes), and every rank runs the host epilogue, so all
    ranks hold the same sketches.

A ``Mesh`` wraps the default process group when one is initialised
(parallel/multihost.py) and a world of one rank otherwise; a world of
one runs no collective and gives the single-device results. Under NCCL
the collectives run on the rank's card; under gloo they run on host
tensors, so card tensors are staged through host memory (the compute
stays on the card). A rank with no share of a genome still joins every
collective.

The JAX mesh's [D, L] rows of packed slabs, its fixed-shape segments
with their overflow recompute and its first-legit-window fix-up have no
counterpart: each rank owns its tensors and uploads its own slab, and K3
compacts into a buffer as long as its windows (it cannot overflow) and
itself flags the first live window after one that is not live.
"""

import numpy as np
import torch
import torch.distributed as dist

from .. import resolve_device
from ..ops import bf_build, bloom, nthash, winmin
from ..ops import sketch as sketch_ops
from ..ops.sketch_device import SEG_WINDOWS, dedupe_pos_hash, sketch_stream

# newer torch names the single-tensor all-gather all_gather_single and
# deprecates all_gather_into_tensor; older torch has only the latter
_ALL_GATHER = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


class Mesh:
    """A 1-D mesh of ranks, one device each: the process group (None for
    a world of one rank), this process's rank, the world size, the rank's
    device, and the device its collectives run on (the card under NCCL,
    the host under gloo)."""

    def __init__(self, group, rank: int, size: int, device: torch.device):
        self.group, self.rank, self.size, self.device = group, rank, size, device
        self.backend = None if group is None else str(dist.get_backend(group))
        nccl = device.type == "cuda" and "nccl" in (self.backend or "")
        self.comm_device = device if nccl else torch.device("cpu")

    def share(self, n: int):
        """[lo, hi) of this rank's even share of n items (empty past n)."""
        s = -(-n // self.size)
        lo = min(self.rank * s, n)
        return lo, min(lo + s, n)


def make_mesh(n_devices: int | None = None, device="cuda") -> Mesh:
    """The mesh of the default process group, or a world of one rank when
    none is initialised. ``device`` is this rank's (for "cuda", the
    current card: parallel/multihost.initialize sets it per rank)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if dist.is_available() and dist.is_initialized():
        group, rank, size = dist.group.WORLD, dist.get_rank(), dist.get_world_size()
    else:
        group, rank, size = None, 0, 1
    n = n_devices or size
    if n != size:
        raise ValueError(
            f"requested {n} devices; the process group has {size} rank(s), one device each")
    return Mesh(group, rank, size, dev)


def _next_pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------


def _all_to_all(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """[D, c] on x's device: row i is chunk ``rank`` of rank i's x [D*c]."""
    send = x.to(mesh.comm_device)
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=mesh.group)
    del send
    return recv.to(x.device).view(mesh.size, -1)


def _all_gather(mesh: Mesh, x: torch.Tensor, async_op: bool = False):
    """Every rank's x [c] laid end to end, [D*c] (on the collective's
    device; with async_op, (out, work) before it lands)."""
    send = x.to(mesh.comm_device)
    out = send.new_empty(mesh.size * send.shape[0])
    work = _ALL_GATHER(out, send, group=mesh.group, async_op=async_op)
    return (out, work) if async_op else out.to(x.device)


def broadcast_object(obj, mesh: Mesh):
    """Rank 0's obj (any picklable value) on every rank of mesh."""
    if mesh.size == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0, group=mesh.group, device=mesh.comm_device)
    return box[0]


def broadcast_bf(bf, mesh: Mesh):
    """Rank 0's filter (None on the other ranks) on every rank of mesh: a
    device filter's words go by one broadcast, a host filter by pickle."""
    if mesh.size == 1:
        return bf
    on_device = isinstance(bf, bloom.BloomFilter)
    head = broadcast_object((bf.num_bits, bf.k) if on_device else bf, mesh)
    if not isinstance(head, tuple):
        return head
    if not on_device:
        bf = bloom.BloomFilter(*head, device=mesh.device)
    buf = bf.words.to(mesh.comm_device)
    dist.broadcast(buf, src=0, group=mesh.group)
    if buf is not bf.words:
        bf.words.copy_(buf)
    return bf


def _chunks(mesh: Mesh, x: torch.Tensor):
    """x flattened and padded with zeros to D equal chunks, and its size."""
    flat = x.reshape(-1)
    n = flat.shape[0]
    pad = -n % mesh.size
    return (torch.cat([flat, flat.new_zeros(pad)]) if pad else flat), n


def allreduce_or(x: torch.Tensor, mesh: Mesh | None = None) -> torch.Tensor:
    """Bitwise-OR all-reduce of an integer tensor (the filters' int32
    words) across the ranks of mesh: every rank gets the OR of every
    rank's x. A world of one returns x itself."""
    mesh = mesh or make_mesh(device=x.device)
    if mesh.size == 1:
        return x
    flat, n = _chunks(mesh, x)
    recv = _all_to_all(mesh, flat)
    own = recv[0].clone()
    for i in range(1, mesh.size):
        own |= recv[i]
    del recv
    return _all_gather(mesh, own)[:n].view(x.shape)


def _allreduce_dup(once: torch.Tensor, mesh: Mesh | None = None):
    """All-reduce of the (seen-once, seen-twice) bit-pair monoid over the
    ranks' seen filters, each rank contributing (once_i, 0):
    (o1, t1) + (o2, t2) = (o1 | o2, t1 | t2 | (o1 & o2)). Returns (once,
    twice): the OR of every rank's filter, and every bit set in at least
    two ranks' filters (the cross-slab duplicates the repeat filter
    needs). One all_to_all of ``once``, the fold over its D chunks, then
    an all-gather of each half."""
    mesh = mesh or make_mesh(device=once.device)
    if mesh.size == 1:
        return once, torch.zeros_like(once)
    flat, n = _chunks(mesh, once)
    recv = _all_to_all(mesh, flat)
    o = recv[0].clone()
    t = torch.zeros_like(o)
    for i in range(1, mesh.size):
        t |= o & recv[i]
        o |= recv[i]
    del recv
    return (_all_gather(mesh, o)[:n].view(once.shape),
            _all_gather(mesh, t)[:n].view(once.shape))


# ---------------------------------------------------------------------------
# Bloom filters
# ---------------------------------------------------------------------------


def _upload(stream, lo: int, hi: int, device) -> torch.Tensor:
    """Codes [lo, hi) of stream on device, sent packed."""
    return sketch_ops.PackedUpload(stream, device, lo, hi).codes


def distributed_common_bf(genomes, k: int, fpr: float = 0.025, mesh: Mesh | None = None,
                          bf_bytes=None) -> bloom.BloomFilter:
    """Cascading common-k-mer Bloom filter over the ranks of mesh: each
    rank inserts the k-mers of its share of a genome into a fresh level
    (K1 and K4), the levels are ORed across
    ranks and ANDed with the previous level. Genomes go in path order and
    the filter is sized as by bf_build.build_common_bf, whose words this
    equals (insert sets commute under OR); every rank returns the same
    filter."""
    mesh = mesh or make_mesh()
    ordered = sorted(genomes, key=lambda g: g.path)
    num_bits = bf_build.bf_size_bits(ordered, fpr, bf_bytes)
    prev = torch.zeros(num_bits // 32, dtype=torch.int32, device=mesh.device)
    for gi, g in enumerate(ordered):
        # w=1 leaves k+1 N codes between contigs, so the k-mers over a
        # separator are invalid and the inserted set is the genome's
        stream = sketch_ops._Stream(g, k, 1)
        n_kmers = max(stream.total - k + 1, 0)
        if n_kmers == 0:
            if gi > 0:
                prev = torch.zeros_like(prev)  # empty genome: empty intersection
            continue
        level = bloom.BloomFilter(num_bits, k, device=mesh.device)
        lo, hi = mesh.share(n_kmers)
        if hi > lo:
            bf_build.insert_stream(
                level, sketch_ops.PackedUpload(stream, mesh.device, lo, hi + k - 1), k)
        own = allreduce_or(level.words, mesh)
        del level
        prev = (own & prev) if gi > 0 else own
    return bloom.BloomFilter(num_bits, k, words=prev)


def repeat_geometry(n_kmers: int, d: int, seg_max: int):
    """(seg, slab) of the repeat walk over D ranks: seg k-mers a segment,
    slab k-mers a rank (a power-of-two count of segments). The JAX
    package's formula (ntsynt_tpu/parallel/mesh.py:664-667): duplicates
    are found within a segment, so the boundaries are part of the
    result."""
    seg = min(seg_max, max(1024, _next_pow2(-(-n_kmers // d))))
    return seg, _next_pow2(-(-n_kmers // (d * seg))) * seg


def distributed_repeat_bf(genomes, k: int, fpr: float = 0.01, mesh: Mesh | None = None,
                          seg_max: int = 1 << 21, bf_bytes=None) -> bloom.BloomFilter:
    """Repeat-k-mer Bloom filter (k-mers of multiplicity >= 2 within any
    single genome) over the ranks of mesh. Each rank walks its slab's
    segments like the single-device walk (bf_build.repeat_segment_update);
    a k-mer repeated across slabs is found by the (once, twice) reduction
    of the ranks' seen filters. Equal, word for word, to the JAX
    package's distributed_repeat_bf over as many devices with the same
    seg_max."""
    mesh = mesh or make_mesh()
    num_bits = bf_build.bf_size_bits(genomes, fpr, bf_bytes)
    rep = bloom.BloomFilter(num_bits, k, device=mesh.device)
    for g in genomes:
        stream = sketch_ops._Stream(g, k, 1)
        n_kmers = max(stream.total - k + 1, 0)
        if n_kmers == 0:
            continue
        seg, slab = repeat_geometry(n_kmers, mesh.size, seg_max)
        lo = mesh.rank * slab
        # segments past the stream's end hold only N codes, so they
        # insert nothing and are skipped
        live = min(max(n_kmers - lo, 0), slab)
        own = bloom.BloomFilter(num_bits, k, device=mesh.device)
        seen = bloom.BloomFilter(num_bits, k, device=mesh.device)
        if live:
            codes = _upload(stream, lo, lo + -(-live // seg) * seg + k - 1, mesh.device)
            for s in range(0, live, seg):
                _, canon, valid = nthash.hash_kmers(codes[s : s + seg + k - 1], k, seg)
                bf_build.repeat_segment_update(own, seen, canon, valid)
            del codes
        _, twice = _allreduce_dup(seen.words, mesh)
        del seen
        rep.words |= allreduce_or(own.words, mesh) | twice
    return rep


# ---------------------------------------------------------------------------
# sketch
# ---------------------------------------------------------------------------


def sharded_sketch_genome(genome, k: int, w: int, mesh: Mesh | None = None,
                          seg_max: int = SEG_WINDOWS, common_bf=None, repeat_bf=None,
                          codes: np.ndarray | None = None) -> sketch_ops.GenomeSketch:
    """The (k, w) minimizer sketch of a genome over the ranks of mesh:
    equal to ops.sketch.sketch_genome with the same filters, on every
    rank."""
    return sharded_sketch_collect(sharded_sketch_dispatch(
        genome, k, w, mesh=mesh, seg_max=seg_max, common_bf=common_bf, repeat_bf=repeat_bf,
        codes=codes))


def sharded_sketch_dispatch(genome, k: int, w: int, mesh: Mesh | None = None,
                            seg_max: int = SEG_WINDOWS, common_bf=None, repeat_bf=None,
                            codes: np.ndarray | None = None) -> dict:
    """Phase 1 of sharded_sketch_genome: this rank sketches its share of
    the stream's windows (uploading only their codes; K1, the probes, K2
    and K3, seg_max windows a segment) and starts gathering every rank's
    selections. Returns a handle for sharded_sketch_collect: the pipeline
    dispatches genome i+1 before it collects genome i, so i's gather
    overlaps i+1's sketch."""
    mesh = mesh or make_mesh()
    stream = sketch_ops._Stream(genome, k, w, codes=codes)
    bits = stream.legit_bits()
    lo, hi = mesh.share(stream.n_windows)
    pos, hsh = np.zeros(0, np.int64), np.zeros(0, np.uint64)
    if sketch_ops.bits_any(bits, lo, hi):
        pos, hsh = sketch_stream(
            _upload(stream, lo, hi + w + k - 2, mesh.device),
            torch.from_numpy(bits[lo >> 3 : -(-hi // 8)]).to(mesh.device), k, w,
            common_bf=common_bf, repeat_bf=repeat_bf, seg=seg_max, legit_offset=lo & 7)
        pos = pos + lo  # int64 stream offsets
    handle = dict(genome=genome, k=k, w=w, codes=codes, stream=stream, common_bf=common_bf,
                  repeat_bf=repeat_bf, local=(pos, hsh), gather=None)
    if mesh.size > 1:
        counts = _all_gather(mesh, torch.tensor([len(pos)], dtype=torch.int64)).tolist()
        m = max(counts)
        if m == 0:  # no rank selected anything: this rank's empty arrays are the result
            return handle
        buf = torch.zeros(2, m, dtype=torch.int64)
        buf[0, : len(pos)] = torch.from_numpy(pos)
        buf[1, : len(pos)] = torch.from_numpy(hsh.view(np.int64))
        out, work = _all_gather(mesh, buf.view(-1), async_op=True)
        handle["gather"] = (out, work, counts, m)
    return handle


def sharded_sketch_collect(handle: dict) -> sketch_ops.GenomeSketch:
    """Phase 2 of sharded_sketch_genome: wait for the gathered selections
    and run the host epilogue (dedupe across slab boundaries, position
    mapping, the short-contig fallback)."""
    pos, hsh = handle["local"]
    if handle["gather"] is not None:
        out, work, counts, m = handle["gather"]
        work.wait()
        rows = out.cpu().view(len(counts), 2, m).numpy()
        pos = np.concatenate([r[0, :c] for r, c in zip(rows, counts)])
        hsh = np.concatenate([r[1, :c] for r, c in zip(rows, counts)]).view(np.uint64)
        pos, hsh = dedupe_pos_hash(pos, hsh)
    return sketch_ops.finish_sketch(
        handle["genome"], handle["stream"], pos, hsh, handle["k"], handle["w"],
        handle["common_bf"], handle["repeat_bf"], handle["codes"])


# ---------------------------------------------------------------------------
# single-step building blocks: each rank passes its own tiles (JAX: its
# shard of the tiles' first axis) and gets its own rows back
# ---------------------------------------------------------------------------


def _tile_hashes(tiles: torch.Tensor, k: int):
    """(key, canon, valid), each [B, NC - k + 1]: every k-mer of every
    uint8 tile [B, NC], from one K1 launch over the tiles laid end to end
    (the k-mers that cross two tiles are dropped)."""
    b, nc = tiles.shape
    out = nthash.hash_kmers(tiles.reshape(-1), k, b * nc - k + 1)
    return tuple(torch.cat([t, t.new_zeros(k - 1)]).view(b, nc)[:, : nc - k + 1] for t in out)


def _tile_argmin(key: torch.Tensor, w: int):
    """Tile-relative leftmost argmin and min of every window of every row
    of key [B, NK], from one K2 launch over the rows laid end to end (the
    windows that cross two rows are dropped)."""
    b, nk = key.shape
    arg, minv = winmin.window_argmin(key.reshape(-1), w)

    def rows(t):
        return torch.cat([t, t.new_zeros(w - 1)]).view(b, nk)[:, : nk - w + 1]

    base = torch.arange(b, dtype=torch.int64, device=key.device)[:, None] * nk
    return rows(arg) - base, rows(minv)


def _check_tiles(tiles: torch.Tensor, nc: int) -> None:
    if tiles.dtype != torch.uint8 or tiles.dim() != 2 or tiles.shape[1] != nc:
        raise ValueError(f"tiles must be uint8 [B, {nc}]")


def sharded_sketch_step(mesh: Mesh, k: int, w: int, chunk: int, bits_log2: int):
    """The multi-device sketch + Bloom-filter step: fn(tiles, words) ->
    (argmins, win_valid, words). Per rank: hash its tiles (uint8 [B,
    chunk + w + k - 2], one window range each), take each window's
    leftmost argmin (int64 [B, chunk], tile-relative) and whether it holds
    a valid k-mer, and insert every valid canonical hash into a local
    filter; the filter ORed with words (int32 [2^bits_log2 / 32]) is then
    OR-reduced across the ranks."""

    def step(tiles, words):
        _check_tiles(tiles, chunk + w + k - 2)
        key, canon, valid = _tile_hashes(tiles, k)
        arg, minv = _tile_argmin(key, w)
        local = bloom.insert_words(torch.zeros_like(words), canon.reshape(-1),
                                   valid.reshape(-1), bits_log2)
        return arg, minv != nthash.SENTINEL, allreduce_or(words | local, mesh)

    return step


def sharded_common_bf_probe_step(mesh: Mesh, k: int, chunk: int, bits_log2: int):
    """The cascade step: fn(tiles, prev_words, acc_words) -> acc_words |
    the OR across ranks of a filter holding every k-mer of the ranks'
    tiles that prev_words holds (src/ntsynt_make_common_bf.cpp:140-160)."""

    def step(tiles, prev_words, acc_words):
        if tiles.dtype != torch.uint8 or tiles.dim() != 2:
            raise ValueError("tiles must be uint8 [B, NC]")
        _, canon, valid = _tile_hashes(tiles, k)
        canon = canon.reshape(-1)
        keep = valid.reshape(-1) & bloom.bf_probe(prev_words, canon, bits_log2)
        nxt = bloom.insert_words(torch.zeros_like(acc_words), canon, keep, bits_log2)
        return acc_words | allreduce_or(nxt, mesh)

    return step


def sharded_filtered_sketch_step(mesh: Mesh, k: int, w: int, chunk: int, common_log2,
                                 repeat_log2):
    """The window-argmin sketch step with the common filter (indexlr -s)
    and the repeat filter (-r) in k-mer validity: fn(tiles, common_words,
    repeat_words) -> (argmins, win_valid), as sharded_sketch_step's; a
    filter whose log2 is None is not probed. Each rank probes its own
    replica of the words."""

    def step(tiles, common_words, repeat_words):
        _check_tiles(tiles, chunk + w + k - 2)
        key, canon, solid = _tile_hashes(tiles, k)
        if common_log2 is not None:
            solid = solid & bloom.bf_probe(common_words, canon, common_log2)
        if repeat_log2 is not None:
            solid = solid & ~bloom.bf_probe(repeat_words, canon, repeat_log2)
        arg, minv = _tile_argmin(torch.where(solid, key, torch.full_like(key, nthash.SENTINEL)),
                                 w)
        return arg, minv != nthash.SENTINEL

    return step


def make_tiles(stream_codes: np.ndarray, n_tiles: int, chunk: int, k: int, w: int) -> np.ndarray:
    """Host: [n_tiles, chunk + w + k - 2] tiles of a code stream, tile t
    covering windows [t*chunk, (t+1)*chunk) with its halo, padded with N
    codes."""
    nc = chunk + w - 1 + k - 1
    tiles = np.full((n_tiles, nc), 4, dtype=np.uint8)
    for t in range(n_tiles):
        seg = stream_codes[t * chunk : t * chunk + nc]
        tiles[t, : len(seg)] = seg
    return tiles
