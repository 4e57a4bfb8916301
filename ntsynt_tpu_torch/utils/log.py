"""Timestamped progress logging.

The reference traces progress with ``print(datetime.datetime.today(), ...)``
(e.g. bin/ntsynt_synteny.py:294,480,545). We keep the same
style so log output is familiar, plus a verbosity switch for --dev mode.
"""

import datetime
import sys

_VERBOSE = False


def set_verbose(value: bool) -> None:
    global _VERBOSE
    _VERBOSE = bool(value)


def is_verbose() -> bool:
    return _VERBOSE


def log(*args, dev_only: bool = False, file=None) -> None:
    """Print a timestamped progress message (flushy, like the reference)."""
    if dev_only and not _VERBOSE:
        return
    print(datetime.datetime.today(), ":", *args, file=file or sys.stdout, flush=True)
