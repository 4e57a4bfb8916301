"""synteny_graph_s: seconds of host synteny's graph work (core/synteny.py,
graph/mxgraph.py, core/assembly.filter_common), the sum of a job's
synteny.filter_common, synteny.graph, synteny.simplify and
synteny.filter_global spans and of each refinement round's
synteny.graph:w<w> and synteny.filter:w<w> (erosion included) in
time.tsv, averaged over the jobs."""

from ._stages import mean_stage

GRAPH = {"synteny.filter_common", "synteny.graph", "synteny.simplify",
         "synteny.filter_global", "synteny.filter"}


def read(jobs):
    return mean_stage(jobs, lambda name: name.split(":")[0] in GRAPH)
