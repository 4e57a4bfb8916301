"""Shared by the stage readers: a stage's seconds from each job's
time.tsv, averaged over the jobs that have it."""


def mean_stage(jobs, match) -> float | None:
    """Mean over the jobs of the summed seconds of the stages for which
    match(name) holds; None when no job has such a stage."""
    vals = []
    for job in jobs:
        secs = [s for name, s in (job.get("stages") or {}).items() if match(name)]
        if secs:
            vals.append(sum(secs))
    return sum(vals) / len(vals) if vals else None
