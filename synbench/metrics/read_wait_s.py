"""read_wait_s: seconds the program waited on the FASTA reads, the sum
of a job's wait_read:* spans in time.tsv (core/pipeline._LazyGenomes: a
thread other than the prefetch thread, finding a genome unread, until it
has it), averaged over the jobs. The reads' share of the critical path,
where read_s is the prefetch thread's own wall."""

from ._stages import mean_stage


def read(jobs):
    return mean_stage(jobs, lambda name: name.startswith("wait_read:"))
