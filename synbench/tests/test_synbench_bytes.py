"""Kernel byte counts against hand counts at small launch sizes."""

import pytest

from synbench import kernels


def _by_key():
    return {k.SHAPES: k for k in kernels.load()}


def test_every_counted_kernel_has_a_module():
    assert set(_by_key()) == {"nthash", "winmin", "compact", "unpack"}


@pytest.mark.parametrize("key,shape,want", [
    # 10 k-mers of k=4: 13 codes read; key 8 + canon 8 + valid 1 written each
    ("nthash", (10, 4), 13 + 170),
    # 10 keys at w=3: 80 bytes read; 8 windows of arg 8 + min 8 written
    ("winmin", (10, 3), 80 + 128),
    # 20 windows: arg 8 + min 8 read each, 3 bytes of legit bits
    ("compact", (20,), 320 + 3),
    # 64 codes: 16 bytes of 2-bit codes and 8 of N bits read, 64 written
    ("unpack", (64,), 24 + 64),
])
def test_hand_counts(key, shape, want):
    assert _by_key()[key].bytes_moved(*shape) == want
