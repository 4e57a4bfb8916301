"""refine_mx_s: seconds of the refinement rounds' new minimizers
(core/synteny.generate_additional_minimizers, core/refine.py, with their
re-sketches on the card), the sum of a job's synteny.new_mx:w<w> spans in
time.tsv, averaged over the jobs. The condense, re-sketch and filter
spans nest in them and are not added again."""

from ._stages import mean_stage


def read(jobs):
    return mean_stage(jobs, lambda name: name.startswith("synteny.new_mx:"))
