"""synteny_s: seconds of host synteny (core/synteny.py, core/blocks.py,
core/refine.py, graph/mxgraph.py, with the refinement rounds'
re-sketches), the synteny stage of time.tsv, averaged over the jobs."""

from ._stages import mean_stage


def read(jobs):
    return mean_stage(jobs, lambda name: name == "synteny")
