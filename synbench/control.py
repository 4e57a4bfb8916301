"""The control and the planted faults of the check that decides
``correct``, read at a cell's own size (judge.py's numbers):

  - control: the reference put in the program's place with one guarantee
    of the configuration broken: its common filter at half the bits, so
    twice the false-positive rate the CLI's --fpr 0.025 states;
  - state_unchanged: the reference with the last cascade level's insert
    left out (the level returns the previous one unchanged);
  - answer_altered: one record of a sketch TSV with its position moved by
    one, and one block's second row with its end k bases short;
  - half_left_out: every other block left out of the blocks TSV.

    python3 -m synbench.control --workload CELL --seed N [--seed M ...]

runs, for each seed, the cell's genomes through one CLI job (job.py, as
a benchmark run does) and prints one JSON line of each number's reading
for the sound job, the control and each fault. The benchmark's runs never
run this.
"""

import argparse
import json
import os
import shutil
import sys
import tempfile

from . import gen, judge, reference, run

K, W, FPR = run.K, run.W, run.FPR


def _sketches(genomes, bloom, bits) -> dict:
    out = {}
    for g in genomes:
        ci, pos, h = reference.sketch(g, K, W, bloom, bits)
        out[g.name] = reference.sketch_tsv(g, K, ci, pos, h)
    return out


def _skip_last_level(genomes, device, bits):
    """The cascade with the last genome's level returned unchanged."""
    ordered = sorted(genomes, key=lambda g: g.name)
    bloom, _, occ = reference.cascade(ordered[:-1], K, FPR, device, bits_log2=bits)
    return bloom, occ + occ[-1:]


def _alter_record(tsv: bytes) -> bytes:
    """The first record's position moved by one."""
    lines = tsv.split(b"\n")
    for i, line in enumerate(lines):
        name, _, recs = line.partition(b"\t")
        if recs:
            h, p, s = recs.split(b" ", 1)[0].split(b":")
            first = b":".join([h, str(int(p) + 1).encode(), s])
            lines[i] = name + b"\t" + first + recs[len(recs.split(b" ", 1)[0]):]
            break
    return b"\n".join(lines)


def _shift_end(blocks: dict, genomes) -> dict:
    out = {b: dict(rows) for b, rows in blocks.items()}
    first = next(iter(out))
    c, s, e, o = out[first][genomes[1].name]
    out[first][genomes[1].name] = (c, s, e - K, o)
    return out


def readings(job_dir: str, genomes, device: str) -> dict:
    """Each number's reading for the sound job in job_dir, the control
    and the faults."""
    log = open(os.path.join(job_dir, "log"), "rb").read()
    got = {g.name: open(os.path.join(job_dir, f"{g.name}.k{K}.w{W}.tsv"), "rb").read()
           for g in genomes}
    blocks = judge.read_blocks(os.path.join(job_dir, f"ntSynt.k{K}.w{W}.synteny_blocks.tsv"))

    def numbers(occ, want, tsvs, blk, log_bytes=log):
        err, unc = judge.block_errors(blk, genomes)
        return {"cascade_diff": judge.cascade_diff(log_bytes, occ),
                "sketch_diff": sum(judge.sketch_diff(tsvs[n], want[n]) for n in want),
                "block_err_bp": err, "uncovered_pct": unc}

    bloom, bits, occ = reference.cascade(genomes, K, FPR, device)
    want = _sketches(genomes, bloom, bits)
    del bloom
    out = {"sound": numbers(occ, want, got, blocks)}
    half, _, half_occ = reference.cascade(genomes, K, FPR, device, bits_log2=bits - 1)
    ctl = _sketches(genomes, half, bits - 1)
    del half
    # the control in the program's place: its occupancies as the log would print them
    ctl_log = "".join(f"Cascade BF occupancy/FPR after x: {x:.4f}\n" for x in half_occ).encode()
    out["control"] = numbers(occ, want, ctl, blocks, ctl_log)
    skip, skip_occ = _skip_last_level(genomes, device, bits)
    skipped = _sketches(genomes, skip, bits)
    del skip
    skip_log = "".join(f"Cascade BF occupancy/FPR after x: {x:.4f}\n" for x in skip_occ).encode()
    out["state_unchanged"] = numbers(occ, want, skipped, blocks, skip_log)
    first = genomes[0].name
    out["answer_altered"] = numbers(occ, want, dict(got, **{first: _alter_record(got[first])}),
                                    _shift_end(blocks, genomes))
    out["half_left_out"] = numbers(occ, want, got,
                                   {b: r for i, (b, r) in enumerate(blocks.items()) if i % 2})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="control and fault readings of a cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, action="append", required=True)
    args = ap.parse_args(argv)
    _, cell, config, traffic = run.load_cell(args.workload)
    run.card(cell["chips"])
    for seed in args.seed:
        base = tempfile.mkdtemp(prefix="synbench-control-")
        try:
            genomes = gen.make_genomes(config, traffic, seed)
            fastas = gen.write_all(genomes, os.path.join(base, "fasta"))
            job = run.run_job(os.path.join(base, "job"), os.path.join(base, "keep"),
                              run.cli_argv(fastas, traffic, False), False, genomes)
            if not job["ok"]:
                print(f"job failed: {run._tail(os.path.join(job['dir'], 'err'))}",
                      file=sys.stderr)
                return 1
            line = {"workload": args.workload, "seed": seed,
                    "readings": readings(job["dir"], genomes, "cuda")}
            print(json.dumps(line), flush=True)
        finally:
            shutil.rmtree(base, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
