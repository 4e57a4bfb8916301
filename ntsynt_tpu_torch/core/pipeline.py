"""End-to-end pipeline: fastas in, synteny-block TSVs out.

Replaces the reference's snakemake DAG (bin/ntsynt_run_pipeline.smk:44-103)
with one in-memory flow, keeping its artifact contract and
resume-from-artifact behavior, in the JAX package's order of stages:

  rule faidx            -> write <basename>.fai
  rule make_common_bf   -> build the cascade + save <prefix>.common.bf
  rule make_repeat_bf   -> build + save <prefix>.repeat.bf (experimental)
  rule indexlr          -> sketch + write <basename>.k<k>.w<w>.tsv
  rule ntsynt_synteny   -> SyntenyDetector.run()

Like snakemake's mtime DAG, an existing sketch TSV newer than its fasta
(and the common BF) is reused instead of re-sketched, and a fresh
byte-complete .bf is loaded instead of rebuilt; --force recomputes
everything. A .bf is a resume stub unless ``bf_artifact="full"``.
Spans of the host work and counts of synteny's work are recorded
(utils/timer.py) and, under --benchmark, written to <prefix>.time.tsv,
<prefix>.spans.tsv and <prefix>.counters.tsv.

Each genome's code stream goes to the device when its cascade level
starts, packed a group at a time (ops/sketch.DeviceStream; the cascade
inserts each group as it lands), and serves both the Bloom-filter
cascade and the sketch; when the cascade's levels and every stream would not fit on
the card (``release_plan``), the streams of the large genomes are
dropped after their levels and built again at their sketches. With
``use_mesh`` the filters and the sketches (the refinement rounds' too)
go through parallel/mesh instead: each rank of the process group builds
and uploads only its own slab of each stream, packed likewise. Every rank computes the
same blocks; ranks other than 0 read and write no artifact: rank 0
decides every reuse and sends what it reuses to the other ranks, so all
ranks join the same collectives.
"""

from dataclasses import dataclass, replace
import json
import os
import threading

import torch
import torch.distributed as dist

from .. import resolve_device
from ..io import fasta as fio
from ..io import sketch_tsv
from ..ops import bf_build, bloom, sketch as sketch_ops
from ..parallel import mesh as pmesh
from ..utils import StageTimer, log, set_verbose
from .assembly import AssemblyMinimizers
from .synteny import SyntenyDetector, SyntenyParams


def _is_bf_stub(path: str) -> bool:
    """True if ``path`` is a BF resume stub (JSON marker) rather than a
    byte-complete Bloom-filter container."""
    try:
        with open(path, "rb") as fin:
            return fin.read(32).lstrip().startswith(b'{"magic": "ntsynt_tpu_bf_stub"')
    except OSError:
        return False


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


# The stream-release rule of the common-filter cascade: the JAX
# pipeline's (ntsynt_tpu/core/pipeline.py, make_common_bf) with the
# port's numbers. The projected residency is two cascade levels plus
# every genome's DeviceStream, a genome's file size standing in for its
# bases (about 1.01 a base with line breaks) so that unread genomes stay
# unread. A DeviceStream holds the unpacked uint8 code stream, one byte
# a base, and the legit-window mask as bits, an eighth of a byte a base:
# 1.125 bytes a base, as the JAX stream (its packed upload's pinned
# staging buffers are host memory). When the projection exceeds the
# budget, the streams of the genomes above the JAX rule's 505 MB line
# are released as their level is done and rebuilt at their sketch (a
# second layout and upload); otherwise every stream stays.
STREAM_BYTES_PER_BASE = 1.125
RELEASE_LINE_BYTES = 505_000_000
# The budget is the card's free memory (the driver's free bytes plus
# what torch's allocator holds unused) less the sketch's per-segment
# temporaries, about 3 GB at SEG_WINDOWS = 2^26 windows (int64 key,
# canon, argmin and min, the validity and probe masks: about 46 B a
# window, ops/sketch_device.py; the cascade's hash outputs, 17 B a
# k-mer, fit inside them), and a margin of 4 GiB for K4's binning
# scratch (8 B a key: 512 MiB at 2^26 keys) and the allocator's
# fragmentation. The JAX rule's 10.5 GB is two thirds of a 16 GB TPU
# chip and does not carry over.
SKETCH_TEMP_BYTES = 46 << 26
RELEASE_MARGIN_BYTES = 4 << 30


def release_plan(sizes: dict, num_bits: int, budget: int) -> set:
    """Names of the genomes whose streams the cascade releases: none when
    two levels of num_bits bits plus every genome's stream (sizes: name
    -> file bytes) fit in budget bytes, else those above the line."""
    resident = 2 * (num_bits // 8) + sum(int(b * STREAM_BYTES_PER_BASE) for b in sizes.values())
    if resident <= budget:
        return set()
    return {n for n, b in sizes.items() if b > RELEASE_LINE_BYTES}


def stream_budget(device) -> int | None:
    """Bytes the cascade's levels and streams may hold on device (None:
    no bound, as on the CPU, where the plan keeps every stream)."""
    if device.type != "cuda":
        return None
    free, _ = torch.cuda.mem_get_info(device)
    unused = torch.cuda.memory_reserved(device) - torch.cuda.memory_allocated(device)
    return free + unused - SKETCH_TEMP_BYTES - RELEASE_MARGIN_BYTES


@dataclass
class PipelineConfig:
    fastas: list
    k: int = 24
    w: int = 1000
    prefix: str | None = None
    fpr: float = 0.025
    bf_bytes: int | None = None  # force the common-BF byte size (up to 2^36 bits)
    block_size: int = 500  # -z
    indel: int = 500  # --bp
    merge: str = "1w"  # --collinear-merge
    w_rounds: tuple = (100, 10)
    n_min_weight: int = 0
    m_orient: float = 90.0
    common: bool = True
    repeat: bool = False  # experimental repeat-BF path
    repeat_filter: str | None = None  # None | 'Filter' | 'Indexlr'
    simplify_graph: bool = True
    benchmark: bool = False
    dev: bool = False
    force: bool = False
    dry_run: bool = False
    write_artifacts: bool = True  # False on ranks other than 0 (set by run)
    use_mesh: bool = False  # shard the BF builds and sketches over the process group's ranks
    bf_artifact: str = "stub"  # "stub" (resume marker; rebuild) | "full" (byte-complete .bf)
    out_dir: str = "."
    device: str = "cuda"
    threads: int = 0  # host threads for the native FASTA reader (-t)

    def resolved_prefix(self) -> str:
        p = self.prefix or f"ntSynt.k{self.k}.w{self.w}"
        return os.path.join(self.out_dir, p)


class _LazyGenomes:
    """Dict-like name -> PackedGenome that reads each FASTA on first
    access (timed as a read_fasta:<name> stage, .fai emitted alongside);
    ``prefetch_async`` reads them ahead on a background thread. Any other
    thread that finds a genome unread times its wait for it as a
    wait_read:<name> span, the read included when it reads it itself."""

    def __init__(self, runner, path_of: dict):
        self._runner = runner
        self._paths = dict(path_of)
        self._loaded = {}
        # per-name locks: the prefetch thread and the pipeline may read
        # different genomes concurrently; a race on the same genome
        # serializes into one read
        self._locks = {n: threading.Lock() for n in path_of}
        self._prefetch = None

    def __getitem__(self, name):
        if name in self._loaded:
            return self._loaded[name]
        if threading.current_thread() is self._prefetch:
            return self._read(name)
        with self._runner.timer.stage(f"wait_read:{name}"):
            return self._read(name)

    def _read(self, name):
        with self._locks[name]:
            if name not in self._loaded:
                runner, cfg = self._runner, self._runner.cfg
                with runner.timer.stage(f"read_fasta:{name}"):
                    g = fio.read_fasta(self._paths[name], threads=cfg.threads)
                    if cfg.write_artifacts:
                        fio.write_fai(g, os.path.join(cfg.out_dir, f"{g.name}.fai"))
                self._loaded[name] = g
        return self._loaded[name]

    def prefetch_async(self, order):
        """Read genomes on a daemon thread in ``order``."""

        def run():
            for n in order:
                self[n]

        t = self._prefetch = threading.Thread(target=run, name="read_prefetch", daemon=True)
        t.start()
        return t


class NtSyntPipeline:
    """The full ntSynt-equivalent run on one torch device."""

    def __init__(self, config: PipelineConfig, timer: StageTimer | None = None):
        """``timer``: the StageTimer to record this run's spans in (the
        CLI's, which also times its set-up); a new one by default."""
        self.cfg = config
        self.device = resolve_device(config.device)
        self.timer = timer or StageTimer()
        if config.benchmark:
            self.timer.track_memory(self.device)
        set_verbose(config.dev)

    def _artifact_fresh(self, artifact: str, *inputs) -> bool:
        """snakemake-style mtime check (bin/ntSynt:155-156 pins
        --rerun-trigger mtime)."""
        if self.cfg.force or not os.path.exists(artifact):
            return False
        amt = os.path.getmtime(artifact)
        return all(os.path.exists(i) and os.path.getmtime(i) <= amt for i in inputs)

    def _reuse_bf(self, path: str, is_rank0: bool, mesh):
        """(fresh, bf) for a filter artifact: whether it is fresh, and the
        filter loaded from it when it is a fresh byte-complete .bf (else
        None: build it). Only rank 0 reads the artifact; on a mesh its
        choice and its filter go to every rank."""
        fresh = is_rank0 and self._artifact_fresh(path, *self.cfg.fastas)
        load = fresh and not _is_bf_stub(path)
        bf = bloom.load_bf(path, device=self.device) if load else None
        if mesh is not None:
            fresh, load = pmesh.broadcast_object((fresh, load), mesh)
            if load:
                bf = pmesh.broadcast_bf(bf, mesh)
        return fresh, bf

    def plan(self):
        """Dry-run description (bin/ntSynt -n)."""
        cfg = self.cfg
        prefix = cfg.resolved_prefix()
        steps = [f"read_fasta + faidx: {f}" for f in cfg.fastas]
        if cfg.common:
            steps.append(f"build_common_bf -> {prefix}.common.bf (fpr={cfg.fpr}, k={cfg.k})")
        if cfg.repeat:
            steps.append(f"build_repeat_bf -> {prefix}.repeat.bf")
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
        # multi-process runs (parallel/multihost.py): every rank computes
        # the same results; only rank 0 touches the file system
        is_rank0 = not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0
        if not is_rank0:
            cfg = self.cfg = replace(cfg, write_artifacts=False, benchmark=False)
        mesh = pmesh.make_mesh(device=self.device) if cfg.use_mesh else None

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

        # one upload per genome, shared by the BF cascade (which inserts
        # its groups as they land) and the sketch
        streams = {}

        def _stream(name):
            if name not in streams:
                streams[name] = sketch_ops.DeviceStream(
                    genomes[name], cfg.k, cfg.w, self.device, timer=self.timer
                )
            return streams[name]

        # --- Bloom filters (rules make_common_bf / make_repeat_bf) ----
        # a fresh byte-complete .bf is loaded; a fresh stub keeps its
        # mtime and the filter is rebuilt; bf_artifact="full" saves the
        # words after sketching, on a thread
        common_bf = repeat_bf = None
        to_save = []

        def _keep(bf, path, fresh):
            if not cfg.write_artifacts:
                return
            if cfg.bf_artifact == "full":
                to_save.append((bf, path))
            elif not fresh:  # a fresh stub keeps its mtime: TSVs stay fresh
                _write_bf_stub(path, bf, cfg)

        if cfg.common:
            bf_path = f"{prefix}.common.bf"
            with self.timer.stage("make_common_bf"):
                fresh, common_bf = self._reuse_bf(bf_path, is_rank0, mesh)
                if common_bf is not None:
                    log(f"Reusing {bf_path}")
                else:
                    if fresh:
                        log(f"Reusing {bf_path} (stub: deterministic on-device rebuild)")
                    if mesh is not None:
                        common_bf = pmesh.distributed_common_bf(
                            [genomes[n] for n in ordered_names], cfg.k, cfg.fpr, mesh=mesh,
                            bf_bytes=cfg.bf_bytes,
                        )
                    else:
                        # sizing needs only the first (path-sorted) genome
                        # (src/ntsynt_make_common_bf.cpp:109-117)
                        num_bits = bf_build.bf_size_bits(
                            [genomes[ordered_names[0]]], cfg.fpr, cfg.bf_bytes
                        )
                        # each genome is packed and uploaded when its
                        # level starts; a released stream is rebuilt at
                        # its sketch (_collect)
                        budget = stream_budget(self.device)
                        drop = set() if budget is None else release_plan(
                            {n: os.path.getsize(path_of[n]) for n in ordered_names},
                            num_bits, budget,
                        )
                        if drop:
                            log(f"Releasing the streams of {sorted(drop)} after their "
                                f"cascade levels (budget {budget} bytes)")
                        common_bf = bf_build.build_common_bf_from_device(
                            [(n, lambda n=n: _stream(n)) for n in ordered_names],
                            cfg.k, num_bits, self.device,
                            release=(lambda n: streams.pop(n, None)) if drop else None,
                            timer=self.timer,
                        )
                    _keep(common_bf, bf_path, fresh)
        if cfg.repeat:
            rbf_path = f"{prefix}.repeat.bf"
            with self.timer.stage("make_repeat_bf"):
                fresh, repeat_bf = self._reuse_bf(rbf_path, is_rank0, mesh)
                if repeat_bf is None:
                    if mesh is not None:
                        # the mesh walk's default segment cap, 2^21, as
                        # in the JAX pipeline: the segments are part of
                        # the result, so past D * 2^20 k-mers of a
                        # one-contig genome this filter is the JAX
                        # mesh's, not the single walk's (at 2^20)
                        repeat_bf = pmesh.distributed_repeat_bf(
                            [genomes[n] for n in names], cfg.k, mesh=mesh,
                        )
                    else:
                        repeat_bf = bf_build.build_repeat_bf(
                            [genomes[n] for n in names], cfg.k, chunk=bf_build.PIPELINE_CHUNK,
                            device=self.device,
                        )
                    _keep(repeat_bf, rbf_path, fresh)

        # --- sketching (rule indexlr) ---------------------------------
        # 'Indexlr' (and a repeat BF with no mode) excludes repeat k-mers
        # from candidacy; 'Filter' sketches without the repeat BF and
        # drops the selected minimizers it holds (read_minimizers)
        sketch_repeat = repeat_bf if cfg.repeat_filter != "Filter" else None
        rep_filter = None
        if cfg.repeat_filter == "Filter" and repeat_bf is not None:
            rep_filter = repeat_bf.probe_np
        # plan the fresh sketches up front: on the mesh, genome i+1's
        # sketch is dispatched before genome i is collected, so i's
        # gather of selections overlaps i+1's sketch
        bf_inputs = [f"{prefix}.common.bf"] if cfg.common else []
        plan = []
        for name in names:
            tsv_path = os.path.join(cfg.out_dir, f"{name}.k{cfg.k}.w{cfg.w}.tsv")
            fresh = rep_filter is not None or not (is_rank0 and self._artifact_fresh(
                tsv_path, path_of[name], *bf_inputs
            ))
            plan.append((name, tsv_path, fresh))
        if mesh is not None:
            plan = pmesh.broadcast_object(plan, mesh)  # rank 0's, whose TSVs it reads
        fresh_queue = [name for name, _, fresh in plan if fresh]

        def _dispatch(name):
            if mesh is None:
                return name  # the single-device sketch runs at collect
            return pmesh.sharded_sketch_dispatch(
                genomes[name], cfg.k, cfg.w, mesh=mesh, common_bf=common_bf,
                repeat_bf=sketch_repeat,
            )

        def _collect(handle):
            if mesh is not None:
                return pmesh.sharded_sketch_collect(handle)
            sk = sketch_ops.sketch_genome(
                genomes[handle], cfg.k, cfg.w, common_bf=common_bf,
                repeat_bf=sketch_repeat, device=self.device, prepared=_stream(handle),
            )
            streams.pop(handle, None)  # free the device stream
            return sk

        assemblies = {}
        artifact_threads = []
        handles = {}
        for name, tsv_path, fresh in plan:
            if not fresh:
                # snakemake-style resume: reuse the sketch artifact
                log(f"Reusing {tsv_path}")
                with self.timer.stage(f"assembly:{name}"):
                    records = sketch_tsv.read_sketch_tsv(tsv_path) if is_rank0 else None
                    if mesh is not None:
                        records = pmesh.broadcast_object(records, mesh)
                    assemblies[name] = AssemblyMinimizers.from_tsv_records(
                        name, records, genome=genomes[name]
                    )
            else:
                with self.timer.stage(f"sketch:{name}"):
                    handle = handles.pop(name, None) or _dispatch(name)
                    fresh_queue.remove(name)
                    if mesh is not None and fresh_queue and fresh_queue[0] not in handles:
                        handles[fresh_queue[0]] = _dispatch(fresh_queue[0])
                    sk = _collect(handle)
                    if cfg.write_artifacts:
                        # the per-minimizer k-mer strings and the file
                        # write run on a background thread
                        def _write_tsv(sk=sk, g=genomes[name], tsv_path=tsv_path):
                            with self.timer.stage(f"write.sketch_tsv:{g.name}"):
                                recs = []
                                for ci, cname in enumerate(sk.contig_names):
                                    mask = sk.contig_idx == ci
                                    seqs = g.kmer_strings(ci, sk.positions[mask], cfg.k)
                                    recs.append(
                                        (cname, sk.hashes[mask], sk.positions[mask], seqs)
                                    )
                                sketch_tsv.write_sketch_tsv(tsv_path, recs)

                        t = threading.Thread(target=_write_tsv, name=f"write.sketch_tsv:{name}")
                        t.start()
                        artifact_threads.append(t)
                with self.timer.stage(f"assembly:{name}"):
                    assemblies[name] = AssemblyMinimizers.from_sketch(
                        sk, genome=genomes[name], repeat_canon_filter=rep_filter
                    )
            log(f"{name}: {len(assemblies[name].mx_info.sorted_hash)} minimizers kept")
        streams.clear()

        # deferred full .bf saves overlap the (host) synteny stage
        def _save(bf, path):
            with self.timer.stage("write.bf"):
                bf.save(path)

        for bf, path in to_save:
            t = threading.Thread(target=_save, args=(bf, path), name="write.bf")
            t.start()
            artifact_threads.append(t)

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
            repeat_bf=repeat_bf,
            repeat_filter=cfg.repeat_filter,
            device=str(self.device),
            mesh=mesh,
            write_output=is_rank0,
            timer=self.timer,
        )
        with self.timer.stage("synteny"):
            out = SyntenyDetector(assemblies, params).run()

        with self.timer.stage("finish"):
            for t in artifact_threads:  # background artifact writes must land on disk
                t.join()
            if cfg.benchmark:
                self.timer.write_tsv(f"{prefix}.time.tsv", f"{prefix}.spans.tsv")
                self.timer.write_counters(f"{prefix}.counters.tsv")
        return out
