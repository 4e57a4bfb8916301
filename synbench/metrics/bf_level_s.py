"""bf_level_s: seconds of one level of the common-filter cascade
(ops/bf_build.build_common_bf_from_device): a job's bf.level:* rows in
time.tsv, one a genome, each from the level's stream fetch (its read
wait and packed upload inside) through the insert, the AND with the
previous level and the occupancy read, which waits for the card; their
sum over their number, averaged over the jobs."""


def read(jobs):
    vals = []
    for job in jobs:
        secs = [s for name, s in (job.get("stages") or {}).items()
                if name.startswith("bf.level:")]
        if secs:
            vals.append(sum(secs) / len(secs))
    return sum(vals) / len(vals) if vals else None
