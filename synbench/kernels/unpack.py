"""Unpack of n codes of the packed upload (csrc/unpack.cu): reads 2 bits
a code and 1 bit of the N bitmap, writes one byte a code."""

SHAPES = "unpack"
EVENTS = ("unpack16_kernel", "unpack1_kernel")


def bytes_moved(n_codes):
    return 3 * n_codes // 8 + n_codes
