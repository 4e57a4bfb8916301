"""End-to-end pipeline: fastas in, synteny-block TSVs out.

Replaces the reference's snakemake DAG (bin/ntsynt_run_pipeline.smk:44-103)
with one in-memory flow, keeping its artifact contract and
resume-from-artifact behavior, in the JAX package's order of stages:

  rule faidx            -> write <basename>.fai
  rule make_common_bf   -> build the cascade + write the <prefix>.common.bf stub
  rule indexlr          -> sketch + write <basename>.k<k>.w<w>.tsv
  rule ntsynt_synteny   -> SyntenyDetector.run()

Like snakemake's mtime DAG, an existing sketch TSV newer than its fasta
(and the common BF) is reused instead of re-sketched; --force recomputes
everything. Per-stage wall-clock is recorded and written to
<prefix>.time.tsv under --benchmark.

Each genome's code stream is uploaded to the device once and serves
both the Bloom-filter cascade and the sketch.
"""

from dataclasses import dataclass
import json
import os
import threading

from .. import resolve_device
from ..io import fasta as fio
from ..io import sketch_tsv
from ..ops import bf_build, sketch as sketch_ops
from ..utils import StageTimer, log, set_verbose
from .assembly import AssemblyMinimizers
from .synteny import SyntenyDetector, SyntenyParams


def _write_bf_stub(path: str, bf, cfg) -> None:
    """Write a resume stub in place of the full bit array: the cascade
    rebuilds deterministically, so the stub carries only the parameters
    (its mtime anchors the snakemake-style freshness chain, like the
    reference's on-disk .bf). Same container as the JAX package's."""
    header = dict(
        magic="ntsynt_tpu_bf_stub",
        num_bits=bf.num_bits,
        k=bf.k,
        hash_fns=1,
        fastas=[os.path.abspath(f) for f in cfg.fastas],
        note="bit array not materialized; rebuilt deterministically on device at resume",
    )
    with open(path, "w") as fout:
        json.dump(header, fout)
        fout.write("\n")


@dataclass
class PipelineConfig:
    fastas: list
    k: int = 24
    w: int = 1000
    prefix: str | None = None
    fpr: float = 0.025
    block_size: int = 500  # -z
    indel: int = 500  # --bp
    merge: str = "1w"  # --collinear-merge
    w_rounds: tuple = (100, 10)
    n_min_weight: int = 0
    m_orient: float = 90.0
    common: bool = True
    simplify_graph: bool = True
    benchmark: bool = False
    dev: bool = False
    force: bool = False
    dry_run: bool = False
    out_dir: str = "."
    device: str = "cuda"

    def resolved_prefix(self) -> str:
        p = self.prefix or f"ntSynt.k{self.k}.w{self.w}"
        return os.path.join(self.out_dir, p)


class _LazyGenomes:
    """Dict-like name -> PackedGenome that reads each FASTA on first
    access (timed as a read_fasta:<name> stage, .fai emitted alongside);
    ``prefetch_async`` reads them ahead on a background thread."""

    def __init__(self, runner, path_of: dict):
        self._runner = runner
        self._paths = dict(path_of)
        self._loaded = {}
        # per-name locks: the prefetch thread and the pipeline may read
        # different genomes concurrently; a race on the same genome
        # serializes into one read
        self._locks = {n: threading.Lock() for n in path_of}

    def __getitem__(self, name):
        if name not in self._loaded:
            with self._locks[name]:
                if name in self._loaded:
                    return self._loaded[name]
                runner, cfg = self._runner, self._runner.cfg
                with runner.timer.stage(f"read_fasta:{name}"):
                    g = fio.read_fasta(self._paths[name])
                    fio.write_fai(g, os.path.join(cfg.out_dir, f"{g.name}.fai"))
                self._loaded[name] = g
        return self._loaded[name]

    def prefetch_async(self, order):
        """Read genomes on a daemon thread in ``order``."""

        def run():
            for n in order:
                self[n]

        t = threading.Thread(target=run, daemon=True)
        t.start()
        return t


class NtSyntPipeline:
    """The full ntSynt-equivalent run on one torch device."""

    def __init__(self, config: PipelineConfig):
        self.cfg = config
        self.device = resolve_device(config.device)
        self.timer = StageTimer(self.device, sample_memory=config.benchmark)
        set_verbose(config.dev)

    def _artifact_fresh(self, artifact: str, *inputs) -> bool:
        """snakemake-style mtime check (bin/ntSynt:155-156 pins
        --rerun-trigger mtime)."""
        if self.cfg.force or not os.path.exists(artifact):
            return False
        amt = os.path.getmtime(artifact)
        return all(os.path.exists(i) and os.path.getmtime(i) <= amt for i in inputs)

    def plan(self):
        """Dry-run description (bin/ntSynt -n)."""
        cfg = self.cfg
        prefix = cfg.resolved_prefix()
        steps = [f"read_fasta + faidx: {f}" for f in cfg.fastas]
        if cfg.common:
            steps.append(f"build_common_bf -> {prefix}.common.bf (fpr={cfg.fpr}, k={cfg.k})")
        for f in cfg.fastas:
            steps.append(
                f"sketch {os.path.basename(f)} -> "
                f"{os.path.basename(f)}.k{cfg.k}.w{cfg.w}.tsv"
            )
        steps.append(
            f"synteny: w_rounds={list(cfg.w_rounds)} bp={cfg.indel} "
            f"merge={cfg.merge} z={cfg.block_size} -> {prefix}.synteny_blocks.tsv"
        )
        return steps

    def run(self) -> str:
        cfg = self.cfg
        prefix = cfg.resolved_prefix()
        if cfg.dry_run:
            for s in self.plan():
                print(s)
            return ""

        # --- load genomes (rule faidx), read ahead on a thread ---------
        names = [os.path.basename(p) for p in cfg.fastas]
        path_of = dict(zip(names, cfg.fastas))
        if len(set(names)) != len(names):
            raise ValueError(
                "duplicate genome file basenames (the basename is the "
                f"assembly key, like the reference): {sorted(names)}"
            )
        if len(names) < 2:
            raise ValueError("Must supply at least two genomes to compare")
        genomes = _LazyGenomes(self, path_of)
        ordered_names = sorted(names, key=lambda n: path_of[n])
        genomes.prefetch_async(ordered_names)

        # one upload per genome, shared by the BF cascade and the sketch
        streams = {}

        def _stream(name):
            if name not in streams:
                streams[name] = sketch_ops.DeviceStream(
                    genomes[name], cfg.k, cfg.w, self.device
                )
            return streams[name]

        # --- common Bloom filter (rule make_common_bf) ----------------
        common_bf = None
        if cfg.common:
            bf_path = f"{prefix}.common.bf"
            with self.timer.stage("make_common_bf"):
                stub_fresh = self._artifact_fresh(bf_path, *cfg.fastas)
                if stub_fresh:
                    log(f"Reusing {bf_path} (stub: deterministic on-device rebuild)")
                # sizing needs only the first (path-sorted) genome
                # (src/ntsynt_make_common_bf.cpp:109-117)
                num_bits = bf_build.bf_size_bits([genomes[ordered_names[0]]], cfg.fpr)
                common_bf = bf_build.build_common_bf_from_device(
                    [(n, _stream(n).codes) for n in ordered_names],
                    cfg.k, num_bits, self.device,
                )
                if not stub_fresh:  # keep mtime: TSVs stay fresh
                    _write_bf_stub(bf_path, common_bf, cfg)

        # --- sketching (rule indexlr) ---------------------------------
        assemblies = {}
        artifact_threads = []
        for name in names:
            tsv_path = os.path.join(cfg.out_dir, f"{name}.k{cfg.k}.w{cfg.w}.tsv")
            bf_inputs = [f"{prefix}.common.bf"] if cfg.common else []
            if self._artifact_fresh(tsv_path, path_of[name], *bf_inputs):
                # snakemake-style resume: reuse the sketch artifact
                log(f"Reusing {tsv_path}")
                records = sketch_tsv.read_sketch_tsv(tsv_path)
                assemblies[name] = AssemblyMinimizers.from_tsv_records(
                    name, records, genome=genomes[name]
                )
            else:
                with self.timer.stage(f"sketch:{name}"):
                    sk = sketch_ops.sketch_genome(
                        genomes[name], cfg.k, cfg.w, common_bf=common_bf,
                        device=self.device, prepared=_stream(name),
                    )
                    streams.pop(name, None)  # free the device stream
                    # the per-minimizer k-mer strings and the file
                    # write run on a background thread
                    def _write_tsv(sk=sk, g=genomes[name], tsv_path=tsv_path):
                        recs = []
                        for ci, cname in enumerate(sk.contig_names):
                            mask = sk.contig_idx == ci
                            seqs = g.kmer_strings(ci, sk.positions[mask], cfg.k)
                            recs.append(
                                (cname, sk.hashes[mask], sk.positions[mask], seqs)
                            )
                        sketch_tsv.write_sketch_tsv(tsv_path, recs)

                    t = threading.Thread(target=_write_tsv)
                    t.start()
                    artifact_threads.append(t)
                assemblies[name] = AssemblyMinimizers.from_sketch(sk, genome=genomes[name])
            log(f"{name}: {len(assemblies[name].mx_info.sorted_hash)} minimizers kept")
        streams.clear()

        # --- core synteny (rule ntsynt_synteny) -----------------------
        params = SyntenyParams(
            k=cfg.k,
            w=cfg.w,
            n=cfg.n_min_weight,
            m=cfg.m_orient,
            z=cfg.block_size,
            bp=cfg.indel,
            collinear_merge=cfg.merge,
            w_rounds=tuple(cfg.w_rounds),
            simplify_graph=cfg.simplify_graph,
            dev=cfg.dev,
            prefix=prefix,
            common_bf=common_bf,
            device=str(self.device),
        )
        with self.timer.stage("synteny"):
            out = SyntenyDetector(assemblies, params).run()

        for t in artifact_threads:  # background artifact writes must land on disk
            t.join()
        if cfg.benchmark:
            self.timer.write_tsv(f"{prefix}.time.tsv")
            log("Stage timings:", self.timer.as_json())
        return out
