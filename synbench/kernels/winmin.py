"""K2, window argmin over n 8-byte keys at window w (csrc/winmin.cu):
reads the keys, writes each window's 8-byte argmin and 8-byte min."""

SHAPES = "winmin"
EVENTS = ("winmin_kernel",)


def bytes_moved(n, w):
    return 8 * n + 16 * (n - w + 1)
