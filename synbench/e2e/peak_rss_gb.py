"""peak_rss_gb: the highest host RSS of any job in the window, sampled
by the worker every 50 ms over its cli.main call, in GB."""


def read(run):
    vals = [j["result"]["peak_rss_bytes"] for j in run["jobs"] if j["ok"]]
    return max(vals) / 1e9 if vals else None
