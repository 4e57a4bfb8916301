"""startup_s: seconds from a job process's start to the port imported
and torch.cuda.init() returned (the worker's own clock, /proc), averaged
over the jobs."""


def read(jobs):
    vals = [job["result"]["startup_s"] for job in jobs if "startup_s" in job["result"]]
    return sum(vals) / len(vals) if vals else None
