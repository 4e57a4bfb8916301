"""job_s: the window's wall over the jobs it completed: seconds from a
user's FASTAs to the blocks TSV, process start-up included."""


def read(run):
    done = [j for j in run["jobs"] if j["ok"]]
    return run["window_s"] / len(done) if done else None
