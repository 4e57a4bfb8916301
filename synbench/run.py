"""The benchmark of ntsynt_tpu_torch: whole CLI jobs, FASTA to blocks TSV.

    python3 -m synbench.run --workload CELL --seed N --seconds S --trace 0|1

from the root of a checkout. A cell (BENCHMARK.json ``workloads``) names
a configuration (configs/, the genomes) and a traffic mix (traffic/, what
they hold and the -d a user picks). A run:

  1. set-up: makes the cell's genomes from the seed (gen.py), writes them
     as FASTA under $TMPDIR, and builds the port's kernel and host
     libraries into the checkout (ntsynt_tpu_torch/_build/) unless they
     are there; the jobs are fresh processes, so nothing else warms up
     for them;
  2. the window: jobs back to back, each a fresh process (job.py) that
     runs the CLI with the cell's FASTAs and -d in a directory of its own,
     deleted after the job; jobs start while less than S seconds have
     passed, and every started job runs to its end;
  3. the check: every job's cascade, sketch TSVs and blocks TSV against
     the plain reference and the planted truth (judge.py), on the card,
     after the window;
  4. the result: one JSON line, last on stdout. With --trace 0 its
     metrics are the cell's end-to-end metrics (e2e/), with --trace 1
     the per-layer ones (metrics/), read from the jobs' time.tsv (the
     CLI's --benchmark), their profiler traces and their kernel launches.

Without a CUDA card, or with fewer than the cell asks for, it exits
non-zero and prints no result.
"""

import argparse
import importlib.util
import json
import os
import resource
import shutil
import subprocess
import sys
import tempfile
import time

from .job import forbidden_loaded

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
K, W, FPR = 24, 1000, 0.025  # the CLI's defaults, which the jobs keep
CHECK_DEVICE = "cuda"  # where the check's plain reference runs


def _load_module(kind: str, name: str):
    path = os.path.join(HERE, kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"synbench.{kind}.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _json(path: str):
    with open(path) as fin:
        return json.load(fin)


def read_benchmark() -> dict:
    return _json(os.path.join(ROOT, "BENCHMARK.json"))


def load_cell(name: str):
    """(benchmark, cell, configuration, traffic) for a workload name."""
    bench = read_benchmark()
    cells = {c["name"]: c for c in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {sorted(cells)}")
    cell = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = _json(os.path.join(ROOT, conf["file"]))
    traffic = _json(os.path.join(HERE, "traffic", f"{cell['traffic']}.json"))
    return bench, cell, config, traffic


def card(chips: int) -> dict:
    """The card this run measures on, without opening a CUDA context in
    this process (the jobs are the card's one user during the window);
    exits non-zero without one."""
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"synbench: needs {chips} CUDA card(s), found {n}; not measuring on the CPU",
              file=sys.stderr)
        raise SystemExit(3)
    info = {"platform": "gpu", "kind": None, "count": chips, "power_limit_w": None}
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader,nounits", "-i", "0"],
                             capture_output=True, text=True, timeout=30).stdout.strip()
        name, limit = out.rsplit(",", 1)
        info.update(kind=name.strip(), power_limit_w=float(limit))
    except (OSError, ValueError, subprocess.SubprocessError):
        pass
    return info


def build_libraries() -> dict:
    """Build the port's kernel and host libraries into
    ntsynt_tpu_torch/_build/ in the checkout unless the ones for their
    sources are there (a checkout's first run); what each took."""
    from ntsynt_tpu_torch.ops import _kernels

    _kernels.build()
    _kernels.build_host()
    return {"kernels": dict(_kernels.BUILD_INFO), "host": dict(_kernels.HOST_BUILD_INFO)}


def cli_argv(fastas: list, traffic: dict, trace: bool) -> list:
    argv = [*fastas, "-d", str(traffic["divergence_pct"])]
    if trace:
        argv.append("--benchmark")
    return argv


def _children_cpu() -> tuple:
    """CPU seconds and major page faults of this process's finished
    children."""
    ru = resource.getrusage(resource.RUSAGE_CHILDREN)
    return ru.ru_utime + ru.ru_stime, ru.ru_majflt


def run_job(work: str, keep: str, argv: list, trace: bool, genomes) -> dict:
    """One job in a fresh process and directory; keeps its outputs that
    the check reads (log, sketch TSVs, blocks TSV, time.tsv) in keep and
    deletes the rest."""
    os.makedirs(work)
    os.makedirs(keep)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([ROOT] + [p for p in [env.get("PYTHONPATH")] if p])
    result = os.path.join(keep, "result.json")
    cmd = [sys.executable, "-m", "synbench.job", "--out", result] + (["--trace"] if trace else [])
    cpu0, majflt0 = _children_cpu()
    t0 = time.perf_counter()
    with open(os.path.join(keep, "log"), "wb") as log, \
            open(os.path.join(keep, "err"), "wb") as err:
        rc = subprocess.run(cmd + ["--"] + argv, cwd=work, env=env, stdout=log,
                            stderr=err).returncode
    wall = time.perf_counter() - t0
    cpu1, majflt1 = _children_cpu()
    prefix = f"ntSynt.k{K}.w{W}"
    names = [f"{g.name}.k{K}.w{W}.tsv" for g in genomes]
    for name in names + [f"{prefix}.synteny_blocks.tsv", f"{prefix}.time.tsv"]:
        if os.path.exists(os.path.join(work, name)):
            os.replace(os.path.join(work, name), os.path.join(keep, name))
    shutil.rmtree(work)
    job = {"rc": rc, "wall_s": wall, "cpu_s": cpu1 - cpu0, "majflt": majflt1 - majflt0,
           "dir": keep, "result": {}}
    if os.path.exists(result):
        job["result"] = _json(result)
    job["ok"] = rc == 0 and job["result"].get("rc") in (0, None)
    stages = os.path.join(keep, f"{prefix}.time.tsv")
    if os.path.exists(stages):
        with open(stages) as fin:
            rows = [line.rstrip("\n").split("\t") for line in fin][1:]
        job["stages"] = {r[0]: float(r[1]) for r in rows if len(r) > 1}
    return job


def _tail(path: str, n: int = 2000) -> str:
    try:
        with open(path, "rb") as fin:
            return fin.read()[-n:].decode(errors="replace")
    except OSError:
        return ""


def check(jobs: list, genomes, device: str) -> dict:
    """Each number compared, with its limit, over every job's outputs."""
    import torch

    from . import judge, reference

    bloom, bits, occ = reference.cascade(genomes, K, FPR, device)
    want = {}
    for g in genomes:
        ci, pos, h = reference.sketch(g, K, W, bloom, bits)
        want[g.name] = reference.sketch_tsv(g, K, ci, pos, h)
    del bloom
    if device != "cpu":
        torch.cuda.empty_cache()
    got = {"cascade_diff": 0, "sketch_diff": 0, "block_err_bp": 0, "uncovered_pct": 0.0}
    for job in jobs:
        with open(os.path.join(job["dir"], "log"), "rb") as fin:
            got["cascade_diff"] += judge.cascade_diff(fin.read(), occ)
        for g in genomes:
            path = os.path.join(job["dir"], f"{g.name}.k{K}.w{W}.tsv")
            data = open(path, "rb").read() if os.path.exists(path) else b""
            got["sketch_diff"] += judge.sketch_diff(data, want[g.name])
        path = os.path.join(job["dir"], f"ntSynt.k{K}.w{W}.synteny_blocks.tsv")
        blocks = judge.read_blocks(path) if os.path.exists(path) else {}
        err, unc = judge.block_errors(blocks, genomes) if blocks else (0, 100.0)
        got["block_err_bp"] = max(got["block_err_bp"], err)
        got["uncovered_pct"] = max(got["uncovered_pct"], unc)
    limits = judge.limits()
    return {name: {"value": got[name], "limit": limits[name]} for name in got}


def run(workload: str, seed: int, seconds: float, trace: bool) -> dict:
    """One run of a cell; prints its result line and returns its object."""
    bench, cell, config, traffic = load_cell(workload)
    if importlib.util.find_spec("ntsynt_tpu_torch") is None:
        print("synbench: the program (ntsynt_tpu_torch) is not in this checkout", file=sys.stderr)
        raise SystemExit(2)
    dev_info = card(cell["chips"])
    from . import gen

    base = tempfile.mkdtemp(prefix="synbench-")
    try:
        t0 = time.perf_counter()
        genomes = gen.make_genomes(config, traffic, seed)
        t1 = time.perf_counter()
        fastas = gen.write_all(genomes, os.path.join(base, "fasta"))
        t2 = time.perf_counter()
        build = build_libraries()
        t3 = time.perf_counter()
        setup_s = t3 - t0
        print(json.dumps({"card": dev_info, "setup": {
            "generate_s": t1 - t0, "write_fasta_s": t2 - t1, "build_s": t3 - t2,
            "fasta_bytes": sum(os.path.getsize(p) for p in fastas),
            "kernels_built": build["kernels"]["cached"] is False,
            "host_built": build["host"]["cached"] is False}}), flush=True)

        jobs = []
        argv = cli_argv(fastas, traffic, trace)
        w0 = time.perf_counter()
        while time.perf_counter() - w0 < seconds:
            i = len(jobs)
            jobs.append(run_job(os.path.join(base, f"job{i}"),
                                os.path.join(base, "keep", f"job{i}"), argv, trace, genomes))
            if not jobs[-1]["ok"]:
                print(f"synbench: job {i} failed (rc {jobs[-1]['rc']}):\n"
                      f"{_tail(os.path.join(jobs[-1]['dir'], 'err'))}", file=sys.stderr)
        window_s = time.perf_counter() - w0

        forbidden = sorted({m for j in jobs for m in j["result"].get("forbidden", [])})
        ok = [j for j in jobs if j["ok"]]
        if ok:
            dev_info["kind"] = ok[0]["result"]["device_name"]
        rate = _json(os.path.join(HERE, "peaks.json")).get(dev_info["kind"], {}).get(
            "hbm_bytes_per_s")
        for job in jobs:
            job["hbm_bytes_per_s"] = rate
        dev_info["memory_peak_bytes"] = max(
            [j["result"].get("device_peak_reserved", 0) for j in ok] or [0])
        run_info = {"jobs": jobs, "window_s": window_s, "setup_s": setup_s}
        metrics, breakdown = {}, None
        if trace:
            for m in bench["per_layer"]:
                v = _load_module("metrics", m["name"]).read(ok)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
            from . import trace as tr

            traces = [j["result"]["trace"] for j in ok if "trace" in j["result"]]
            bw = [tr.busy_and_window(t) for t in traces]
            bw = [x for x in bw if x]
            if bw:
                dev_info["busy_s"] = sum(b for b, _ in bw) / 1e6 / dev_info["count"]
                dev_info["window_s"] = sum(w for _, w in bw) / 1e6
            breakdown = {"device_ops": tr.device_ops(traces),
                         "idle_gaps": sorted((g for t in traces for g in tr.idle_gaps(t)),
                                             key=lambda g: -g[1])[:10]}
        else:
            for m in bench["end_to_end"]:
                v = _load_module("e2e", m["name"]).read(run_info)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}

        c0 = time.perf_counter()
        checks = check(ok, genomes, CHECK_DEVICE) if ok else {}
        check_s = time.perf_counter() - c0
        correct = bool(ok) and len(ok) == len(jobs) and all(
            c["value"] <= c["limit"] for c in checks.values())
        forbidden = sorted(set(forbidden) | set(forbidden_loaded()))
        if forbidden:
            print(f"synbench: forbidden modules loaded: {forbidden}", file=sys.stderr)
            raise SystemExit(4)
        line = {"correct": correct, "attempted": len(jobs), "failed": len(jobs) - len(ok),
                "metrics": metrics, "device": dev_info}
        if breakdown is not None:
            line["breakdown"] = breakdown
        line["window"] = {"jobs": len(jobs), "window_s": window_s, "check_s": check_s,
                          "job_wall_s": [j["wall_s"] for j in jobs],
                          "job_startup_s": [j["result"].get("startup_s") for j in jobs],
                          "job_call_s": [j["result"].get("call_s") for j in jobs],
                          "job_cpu_s": [j["cpu_s"] for j in jobs],
                          "job_majflt": [j["majflt"] for j in jobs],
                          "build": build}
        line["checks"] = checks
        for name, c in checks.items():
            print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
        print(json.dumps(line), flush=True)
        return line
    finally:
        shutil.rmtree(base, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=[0, 1], default=0)
    args = ap.parse_args(argv)
    run(args.workload, args.seed, args.seconds, bool(args.trace))
    return 0


if __name__ == "__main__":
    sys.exit(main())
