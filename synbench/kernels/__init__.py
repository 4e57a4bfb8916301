"""Byte counts of the port's kernels, one module each: ``SHAPES`` (the
kernel's key in ops/_kernels.SHAPES), ``EVENTS`` (its CUDA function
names as the profiler reports them) and ``bytes_moved(*shape)``: the
bytes one launch of that shape must move, each input read once and each
output written once."""

import glob
import importlib
import os


def load():
    here = os.path.dirname(os.path.abspath(__file__))
    names = sorted(os.path.basename(p)[:-3] for p in glob.glob(os.path.join(here, "*.py")))
    return [importlib.import_module(f"{__name__}.{n}") for n in names if not n.startswith("_")]
