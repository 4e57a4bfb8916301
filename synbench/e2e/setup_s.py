"""setup_s: seconds of set-up: the genomes generated and written as
FASTA, and the port's kernel and host libraries built (a checkout's
first run) or found built."""


def read(run):
    return run["setup_s"]
