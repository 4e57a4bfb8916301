"""K3, compaction of nw windows (csrc/compact.cu): reads each window's
8-byte argmin and 8-byte min and its legit bit. The 16 bytes of each
selected minimizer it writes are left out: SHAPES does not record how
many there are (about 2 / (w + 1) of the windows, under 0.2% of these
bytes at w = 1000), so this bound is a little low."""

SHAPES = "compact"
EVENTS = ("compact_kernel",)


def bytes_moved(nw):
    return 16 * nw + -(-nw // 8)
