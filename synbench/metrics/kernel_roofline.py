"""kernel_roofline: percent of their byte bound that the kernels with a
byte count in synbench/kernels/ reach over a whole job: the sum over
their launches of bytes moved / the card's memory rate (peaks.json),
over the sum of their device times (the profiler's kernel events,
matched by name). Launch sizes come from ops/_kernels.SHAPES, which the
worker dumps after the job."""

import re

from .. import kernels as kernel_counts


def read(jobs):
    bound = spent = 0.0
    for job in jobs:
        res = job["result"]
        rate = job.get("hbm_bytes_per_s")
        tr = res.get("trace")
        if not rate or not tr:
            continue
        for kern in kernel_counts.load():
            pat = re.compile(r"\b(" + "|".join(kern.EVENTS) + r")\b")
            t = sum(dur for cat, name, _, dur in tr["device"]
                    if cat == "kernel" and pat.search(name))
            launches = res["shapes"].get(kern.SHAPES, [])
            if t <= 0 or not launches:
                continue
            bound += sum(kern.bytes_moved(*s) for s in launches) / rate
            spent += t / 1e6
    return 100.0 * bound / spent if spent > 0 else None
