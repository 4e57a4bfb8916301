"""peak_device_gb: the highest torch.cuda.max_memory_allocated of any
job in the window, read by the worker after cli.main returns, in GB."""


def read(run):
    vals = [j["result"]["device_peak_allocated"] for j in run["jobs"] if j["ok"]]
    return max(vals) / 1e9 if vals else None
