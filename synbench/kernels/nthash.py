"""K1, ntHash of n k-mers (csrc/nthash.cu): reads n + k - 1 one-byte
codes, writes each k-mer's 8-byte key, 8-byte canonical hash and 1-byte
validity."""

SHAPES = "nthash"
EVENTS = ("nthash_kernel",)


def bytes_moved(n_kmers, k):
    return (n_kmers + k - 1) + 17 * n_kmers
