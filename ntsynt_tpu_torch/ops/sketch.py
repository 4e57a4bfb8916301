"""Minimizer sketching of whole genomes (indexlr replacement).

Replaces the btllib ``indexlr`` binary (``-k -w --long --seq --pos
[-s common.bf]``, bin/ntsynt_run_pipeline.smk:85) and its re-invocation
in refinement rounds (bin/ntsynt_synteny.py:173-182):

  1. All contigs of a genome are concatenated into one code stream with
     (w+k) N-code separators, so k-mers and windows never straddle a
     contig boundary; a host-built legit-window mask marks the windows
     that exist in per-contig semantics.
  2. The stream lives on the device and ops/sketch_device selects the
     minimizers (hash, common-BF probe, window argmin, compaction).
  3. Selected stream positions are mapped back to (contig, position);
     hashes are the printed ntHash values, positions 0-based k-mer
     starts.

Contigs with at least one but fewer than w k-mers get a host-side
fallback (one window over all their k-mers), so they are not dropped.
"""

from dataclasses import dataclass

import numpy as np
import torch

from . import nthash
from .. import resolve_device
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


class _Stream:
    """A genome's contigs packed into one code stream with separators."""

    def __init__(self, genome, k: int, w: int, codes: np.ndarray | None = None):
        self.genome = genome
        self.k, self.w = k, w
        sep = w + k  # windows can never span two contigs
        self._src = genome.codes if codes is None else codes
        starts, pos = [], 0
        for i in range(genome.n_contigs):
            starts.append(pos)
            pos += int(genome.lengths[i]) + sep
        self.starts = np.asarray(starts, dtype=np.int64)
        self.total = pos

    @property
    def codes(self) -> np.ndarray:
        """The uint8 stream: contigs at ``starts``, code 4 elsewhere."""
        g = self.genome
        buf = np.full(self.total, 4, dtype=np.uint8)
        for i in range(g.n_contigs):
            o, ln = int(g.offsets[i]), int(g.lengths[i])
            s = int(self.starts[i])
            buf[s : s + ln] = self._src[o : o + ln]
        return buf

    def legit_windows(self) -> np.ndarray:
        """bool [n_windows_stream]: windows fully inside one contig."""
        k, w = self.k, self.w
        nwin = max(self.total - (w + k - 1) + 1, 0)
        legit = np.zeros(nwin, dtype=bool)
        for i in range(len(self.starts)):
            nk = int(self.genome.lengths[i]) - k + 1
            if nk >= w:
                s = int(self.starts[i])
                legit[s : s + nk - w + 1] = True
        return legit

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


class DeviceStream:
    """A genome's _Stream uploaded once: the code stream and the
    legit-window mask as device tensors, shared by the Bloom-filter
    cascade and the sketcher."""

    def __init__(self, genome, k: int, w: int, device, codes: np.ndarray | None = None):
        self.stream = _Stream(genome, k, w, codes=codes)
        self.codes = torch.from_numpy(self.stream.codes).to(device)
        self.legit = torch.from_numpy(self.stream.legit_windows()).to(device)


def sketch_genome(genome, k: int, w: int, common_bf=None, device="cuda",
                  codes: np.ndarray | None = None, prepared: DeviceStream | None = None
                  ) -> GenomeSketch:
    """Compute the (k, w) minimizer sketch of a genome.

    Args:
      genome: io.fasta.PackedGenome.
      common_bf: optional ops.bloom.BloomFilter on ``device``; only k-mers
        it holds are minimizer candidates (indexlr -s).
      device: torch device the sketch runs on.
      codes: optional override of genome.codes (refinement rounds sketch
        a masked copy).
      prepared: optional DeviceStream of this genome already on
        ``device`` (the pipeline's one upload, shared with the BF build).
    """
    if prepared is None:
        prepared = DeviceStream(genome, k, w, resolve_device(device), codes=codes)
    ds = prepared
    stream = ds.stream
    sel, selh = sketch_stream(ds.codes, ds.legit, k, w, common_bf=common_bf)
    cidx, cpos = stream.to_contig_pos(sel)

    # short-contig fallback (one window over all k-mers), host-side
    src = genome.codes if codes is None else codes
    extra_ci, extra_pos, extra_h = [], [], []
    for i in stream.short_contigs():
        o, ln = int(genome.offsets[i]), int(genome.lengths[i])
        canon, out, valid = nthash.hash_sequence_np(src[o : o + ln], k)
        if common_bf is not None:
            valid = valid & common_bf.probe_np(canon)
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
