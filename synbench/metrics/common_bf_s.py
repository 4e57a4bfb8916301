"""common_bf_s: seconds of the common-filter cascade (ops/bf_build.py,
ops/bloom.py, ops/sketch.PackedUpload, core/pipeline.py), the
make_common_bf stage of time.tsv (waits for reads and uploads
included), averaged over the jobs."""

from ._stages import mean_stage


def read(jobs):
    return mean_stage(jobs, lambda name: name == "make_common_bf")
