from .stats import compute_stats  # noqa: F401
