"""synteny_blocks_s: seconds of host synteny's paths and blocks
(core/synteny.py, core/blocks.py), the sum of a job's synteny.paths,
synteny.blocks, synteny.indel_minmx, synteny.write_blocks, synteny.merge
and synteny.dot_join spans, each refinement round's (":w<w>") included,
in time.tsv, averaged over the jobs. The synteny.lookup spans nest in
synteny.blocks and are not added again."""

from ._stages import mean_stage

BLOCKS = {"synteny.paths", "synteny.blocks", "synteny.indel_minmx", "synteny.write_blocks",
          "synteny.merge", "synteny.dot_join"}


def read(jobs):
    return mean_stage(jobs, lambda name: name.split(":")[0] in BLOCKS)
