"""dedupe_s: seconds of the within-assembly dedupe
(core/assembly.AssemblyMinimizers.from_arrays: the np.unique of a
sketch's hashes and the gathers that drop every hash found more than
once), the sum of a job's assembly.dedupe:* spans in time.tsv, the
sketches' (inside assembly:<g>) and each refinement round's
(assembly.dedupe:w<w>:<a>) alike, averaged over the jobs. A program
without the span gives None."""

from ._stages import mean_stage


def read(jobs):
    return mean_stage(jobs, lambda name: name.startswith("assembly.dedupe:"))
