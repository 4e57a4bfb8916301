"""sketch_s: seconds of the minimizer sketches (ops/sketch.py,
ops/sketch_device.py), the sum of a job's sketch:* stages in time.tsv,
averaged over the jobs."""

from ._stages import mean_stage


def read(jobs):
    return mean_stage(jobs, lambda name: name.startswith("sketch:"))
