"""upload_host_s: host seconds of the packed uploads (ops/sketch.
PackedUpload, DeviceStream), the sum of a job's upload.* spans in
time.tsv: each group's pack and enqueue (upload.pack:*), its wait for a
staging buffer (upload.wait:*) and the legit bits built and copied
(upload.legit:*), in the cascade, the sketches and the refinement
re-sketches alike, averaged over the jobs."""

from ._stages import mean_stage


def read(jobs):
    return mean_stage(jobs, lambda name: name.startswith("upload."))
