"""synteny_join_s: seconds of host synteny's per-assembly sort-merge
joins (core/synteny.SyntenyDetector._lookup, its batched branch; each
assembly's MxInfo.lookup_unique_sorted and the gathers after it), the
sum of a job's synteny.join:* spans in time.tsv, every pass and round
alike, averaged over the jobs. They run inside synteny.lookup."""

from ._stages import mean_stage


def read(jobs):
    return mean_stage(jobs, lambda name: name.startswith("synteny.join:"))
