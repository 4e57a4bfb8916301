"""read_s: seconds of the FASTA reads (io/fasta.py, the native packer),
the sum of a job's read_fasta:* stages in time.tsv, averaged over the
jobs. The reads run on a prefetch thread: this is their own wall, not
their share of the critical path."""

from ._stages import mean_stage


def read(jobs):
    return mean_stage(jobs, lambda name: name.startswith("read_fasta:"))
