"""Minimizer sketching of whole genomes (indexlr replacement).

Replaces the btllib ``indexlr`` binary (``-k -w --long --seq --pos
[-s common.bf] [-r repeat.bf]``, bin/ntsynt_run_pipeline.smk:85) and its re-invocation
in refinement rounds (bin/ntsynt_synteny.py:173-182):

  1. All contigs of a genome are concatenated into one code stream with
     (w+k) N-code separators, so k-mers and windows never straddle a
     contig boundary; a legit-window mask, one bit a window, marks the
     windows that exist in per-contig semantics.
  2. The stream goes to the device packed, a group at a time
     (PackedUpload: 0.375 bytes a base sent, unpacked on the card), and
     ops/sketch_device selects the minimizers (hash, common- and
     repeat-BF probes, window argmin, compaction).
  3. Selected stream positions are mapped back to (contig, position);
     hashes are the printed ntHash values, positions 0-based k-mer
     starts.

Contigs with at least one but fewer than w k-mers get a host-side
fallback (one window over all their k-mers), so they are not dropped.
"""

from dataclasses import dataclass

import numpy as np
import torch

from . import nthash, unpack
from .. import resolve_device
from ..io import fasta as fio
from .sketch_device import sketch_stream


@dataclass
class GenomeSketch:
    """Minimizer sketch of one genome."""

    name: str  # assembly key (genome file basename)
    k: int
    w: int
    contig_names: list
    # per-minimizer flat arrays, ordered by (contig, position):
    contig_idx: np.ndarray  # int32 [m]
    positions: np.ndarray  # int64 [m] 0-based k-mer starts
    hashes: np.ndarray  # uint64 [m] printed/ordering hash
    canon: np.ndarray  # uint64 [m] canonical hash (BF key)

    @property
    def n_minimizers(self) -> int:
        return len(self.positions)

    def subset(self, keep: np.ndarray) -> "GenomeSketch":
        """New sketch restricted to the boolean mask ``keep``."""
        return GenomeSketch(
            name=self.name, k=self.k, w=self.w, contig_names=self.contig_names,
            contig_idx=self.contig_idx[keep], positions=self.positions[keep],
            hashes=self.hashes[keep], canon=self.canon[keep],
        )


class _Stream:
    """A genome's contigs laid out as one code stream with separators:
    contig i at ``starts[i]``, then ``sep`` N codes (w + k by default, so
    windows never span two contigs). The stream is never laid out on the
    host: ``pack`` packs any range of it for the device."""

    def __init__(self, genome, k: int, w: int, codes: np.ndarray | None = None,
                 sep: int | None = None):
        self.genome = genome
        self.k, self.w = k, w
        sep = w + k if sep is None else sep
        self._src = genome.codes if codes is None else codes
        starts, pos = [], 0
        for i in range(genome.n_contigs):
            starts.append(pos)
            pos += int(genome.lengths[i]) + sep
        self.starts = np.asarray(starts, dtype=np.int64)
        self.total = pos

    @property
    def n_windows(self) -> int:
        return max(self.total - (self.w + self.k - 1) + 1, 0)

    def pack(self, lo: int, hi: int, out_len: int, out=None):
        """Codes [lo, hi) of the stream (code 4 past its end), padded with
        code 4 to out_len (a multiple of 8, >= hi - lo), in the upload's
        packing: (packed2 uint8 [out_len/4], nbits uint8 [out_len/8])
        (io/fasta.pack_stream; out as there)."""
        g = self.genome
        lo, hi = int(lo), int(hi)
        a = np.clip(self.starts, lo, hi)
        b = np.clip(self.starts + g.lengths, lo, hi)
        keep = b > a
        return fio.pack_stream(self._src, (g.offsets + a - self.starts)[keep], (b - a)[keep],
                               a[keep] - lo, out_len, out=out)

    def legit_bits(self) -> np.ndarray:
        """uint8 [ceil(n_windows / 8)]: the legit-window mask as
        little-endian bits (byte b holds windows 8b .. 8b + 7, lowest
        first), set for the windows fully inside one contig."""
        k, w = self.k, self.w
        bits = np.zeros(-(-self.n_windows // 8), dtype=np.uint8)
        for i in range(len(self.starts)):
            nk = int(self.genome.lengths[i]) - k + 1
            if nk >= w:
                s = int(self.starts[i])
                _set_bits(bits, s, s + nk - w + 1)
        return bits

    def short_contigs(self):
        """Indices of contigs with at least one k-mer but fewer than w."""
        k, w = self.k, self.w
        return [
            i
            for i in range(self.genome.n_contigs)
            if 1 <= int(self.genome.lengths[i]) - k + 1 < w
        ]

    def to_contig_pos(self, stream_pos: np.ndarray):
        idx = np.searchsorted(self.starts, stream_pos, side="right") - 1
        return idx.astype(np.int32), stream_pos - self.starts[idx]


def _set_bits(bits: np.ndarray, lo: int, hi: int) -> None:
    """Set little-endian bits [lo, hi) of bits (lo < hi)."""
    b0, b1 = lo >> 3, hi >> 3
    if b0 == b1:
        bits[b0] |= ((1 << (hi - lo)) - 1) << (lo & 7)
        return
    bits[b0] |= (0xFF << (lo & 7)) & 0xFF
    bits[b0 + 1 : b1] = 0xFF
    if hi & 7:
        bits[b1] |= (1 << (hi & 7)) - 1


def bits_any(bits: np.ndarray, lo: int, hi: int) -> bool:
    """Whether any of the little-endian bits [lo, hi) of bits is set."""
    if hi <= lo:
        return False
    b0, b1 = lo >> 3, (hi - 1) >> 3
    first = int(bits[b0]) >> (lo & 7)
    if b0 == b1:
        return bool(first & ((1 << (hi - lo)) - 1))
    last = int(bits[b1]) & ((1 << (((hi - 1) & 7) + 1)) - 1)
    return bool(first or last or bits[b0 + 1 : b1].any())


# k-mers a group of the upload: one ops/bf_build.SEG_KMERS segment, and
# the JAX package's group (8 segments of its 2^23-k-mer chunk)
GROUP_KMERS = 1 << 26


def _round8(n: int) -> int:
    return -(-n // 8) * 8


class PackedUpload:
    """Codes [lo, hi) of a _Stream on the device, sent packed a group at
    a time: the counterpart of the JAX package's ChunkedSharedStream
    (ntsynt_tpu/ops/sketch.py).

    The range goes up in groups of ``group`` = GROUP_KMERS k-mers (read
    when the upload is made). Group g sends codes
    [g*group, (g+1)*group) of the range, the last group everything to hi,
    so each code is sent and written once: packed on the host
    (_Stream.pack, 0.375 bytes a code) into one of two pinned staging
    buffers, used in turn (a buffer is packed again only once the copy
    that last read it has ended), copied without blocking on a side CUDA
    stream and unpacked on the card (ops/unpack) straight into its place
    in one device buffer, allocated once and covered whole by the
    groups' unpacks (padding included, code 4). A group's k-mers also
    need the next group's first k - 1 codes, so ``groups`` hands group g
    over once group g + 1 has landed, and the consumer's stream waits on
    that group's event: the host packs group g + 2 while the card works
    on group g. On the CPU the same groups go through plain copies and
    the plain unpack.
    """

    def __init__(self, stream: _Stream, device, lo: int = 0, hi: int | None = None):
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.stream, self.k, self.device = stream, stream.k, device
        self.group = group = GROUP_KMERS
        self.lo = int(lo)
        self.n = max((stream.total if hi is None else int(hi)) - self.lo, 0)
        n_kmers = max(self.n - self.k + 1, 0)
        self.n_groups = max(-(-n_kmers // group), 1) if self.n else 0
        self._sent = 0
        self._buf = self._stage = self._host = self._side = None
        self._host_free = [None, None]  # per staging buffer, its last copy's event
        self._landed = []  # per group, the side stream's event after its unpack

    def _send(self) -> None:
        """Pack, copy and unpack the next group."""
        g = self._sent
        a = g * self.group
        b = self.n if g == self.n_groups - 1 else a + self.group
        n8, cuda = _round8(b - a), self.device.type == "cuda"
        if self._buf is None:
            width = 3 * _round8(min(self.n, self.group + self.k - 1)) // 8
            self._buf = torch.empty(_round8(self.n), dtype=torch.uint8, device=self.device)
            # pin_memory raises when pinning fails: there is no pageable path
            self._host = [torch.empty(width, dtype=torch.uint8, pin_memory=cuda)
                          for _ in range(2)]
            if cuda:
                # the copies and unpacks run on a stream of torch's pool;
                # the buffer's memory may still be read by earlier work
                side = self._side = torch.cuda.Stream(self.device)
                side.wait_stream(torch.cuda.current_stream(self.device))
                self._buf.record_stream(side)
                with torch.cuda.stream(side):
                    self._stage = torch.empty(width, dtype=torch.uint8, device=self.device)
        host = self._host[g % 2]
        if self._host_free[g % 2] is not None:
            self._host_free[g % 2].synchronize()
        q, nb = n8 // 4, 3 * n8 // 8
        self.stream.pack(self.lo + a, self.lo + b, n8, out=(host[:q].numpy(), host[q:nb].numpy()))
        out = self._buf[a : a + n8]
        if cuda:
            side = self._side
            with torch.cuda.stream(side):
                stage = self._stage[:nb]
                stage.copy_(host[:nb], non_blocking=True)
                self._host_free[g % 2] = torch.cuda.Event()
                self._host_free[g % 2].record(side)
                unpack.unpack(stage[:q], stage[q:], out=out)
                self._landed.append(torch.cuda.Event())
                self._landed[-1].record(side)
        else:
            unpack.unpack(host[:q], host[q:nb], out=out)
        self._sent += 1
        if self._sent == self.n_groups:
            self._host = self._stage = None

    def _wait(self, g: int) -> None:
        """The current stream waits until group g (and every one before
        it) has landed."""
        if self._landed:
            torch.cuda.current_stream(self.device).wait_event(self._landed[g])

    def groups(self):
        """Each group's k-mers as a device view, in order: codes
        [g*group, min((g+1)*group + k - 1, n)) of the range, each handed
        over once those codes have landed. The groups are walked once,
        before ``codes`` is asked for."""
        if self._sent:
            raise RuntimeError("PackedUpload.groups: the groups were already sent")
        for g in range(self.n_groups):
            ahead = min(g + 1, self.n_groups - 1)
            while self._sent <= ahead:
                self._send()
            self._wait(ahead)
            a = g * self.group
            yield self._buf[a : min(a + self.group + self.k - 1, self.n)]

    @property
    def codes(self) -> torch.Tensor:
        """The range's codes, uint8 [hi - lo] on the device, once every
        group has landed (the groups not yet sent are sent now)."""
        while self._sent < self.n_groups:
            self._send()
        if self._buf is None:
            return torch.empty(0, dtype=torch.uint8, device=self.device)
        self._wait(self.n_groups - 1)
        return self._buf[: self.n]


class DeviceStream(PackedUpload):
    """A genome's _Stream on the device, shared by the Bloom-filter
    cascade (``groups``) and the sketcher (``codes``, ``legit``): its
    codes sent packed a group at a time (PackedUpload), 1 byte a base on
    the card, and its legit-window mask as bits, 1/8 byte a window, sent
    at its first use."""

    def __init__(self, genome, k: int, w: int, device, codes: np.ndarray | None = None):
        super().__init__(_Stream(genome, k, w, codes=codes), device)
        self._legit = None

    @property
    def legit(self) -> torch.Tensor:
        """uint8 [ceil(n_windows / 8)] legit-window bits on the device."""
        if self._legit is None:
            self._legit = torch.from_numpy(self.stream.legit_bits()).to(self.device)
        return self._legit


def sketch_genome(genome, k: int, w: int, common_bf=None, repeat_bf=None, device="cuda",
                  codes: np.ndarray | None = None, prepared: DeviceStream | None = None
                  ) -> GenomeSketch:
    """Compute the (k, w) minimizer sketch of a genome.

    Args:
      genome: io.fasta.PackedGenome.
      common_bf: optional ops.bloom.BloomFilter on ``device`` (or a
        HostModBloomFilter, probed on the host); only k-mers it holds are
        minimizer candidates (indexlr -s).
      repeat_bf: optional filter of the same kinds; k-mers it holds are
        not candidates (indexlr -r).
      device: torch device the sketch runs on.
      codes: optional override of genome.codes (refinement rounds sketch
        a masked copy).
      prepared: optional DeviceStream of this genome already on
        ``device`` (the pipeline's one upload, shared with the BF build).
    """
    if prepared is None:
        prepared = DeviceStream(genome, k, w, resolve_device(device), codes=codes)
    sel, selh = sketch_stream(prepared.codes, prepared.legit, k, w, common_bf=common_bf,
                              repeat_bf=repeat_bf)
    return finish_sketch(genome, prepared.stream, sel, selh, k, w, common_bf, repeat_bf, codes)


def finish_sketch(genome, stream: _Stream, sel: np.ndarray, selh: np.ndarray, k: int, w: int,
                  common_bf=None, repeat_bf=None, codes: np.ndarray | None = None
                  ) -> GenomeSketch:
    """The host epilogue of a sketch: the selected stream positions
    ``sel`` (sorted, unique) and their hashes ``selh`` mapped to (contig,
    position), plus the short-contig fallback."""
    cidx, cpos = stream.to_contig_pos(sel)

    # short-contig fallback (one window over all k-mers), host-side
    src = genome.codes if codes is None else codes
    extra_ci, extra_pos, extra_h = [], [], []
    for i in stream.short_contigs():
        o, ln = int(genome.offsets[i]), int(genome.lengths[i])
        canon, out, valid = nthash.hash_sequence_np(src[o : o + ln], k)
        if common_bf is not None:
            valid = valid & common_bf.probe_np(canon)
        if repeat_bf is not None:
            valid = valid & ~repeat_bf.probe_np(canon)
        if valid.any():
            keys = np.where(valid, out, np.uint64(0xFFFFFFFFFFFFFFFF))
            a = int(np.argmin(keys))
            extra_ci.append(i)
            extra_pos.append(a)
            extra_h.append(out[a])
    if extra_ci:
        cidx = np.concatenate([cidx, np.asarray(extra_ci, np.int32)])
        cpos = np.concatenate([cpos, np.asarray(extra_pos, np.int64)])
        order = np.lexsort((cpos, cidx))
        cidx, cpos = cidx[order], cpos[order]
        selh = np.concatenate([selh, np.asarray(extra_h, np.uint64)])[order]

    return GenomeSketch(
        name=genome.name,
        k=k,
        w=w,
        contig_names=list(genome.contig_names),
        contig_idx=cidx,
        positions=cpos,
        hashes=selh,
        canon=nthash.unmix_np(selh, k),
    )
