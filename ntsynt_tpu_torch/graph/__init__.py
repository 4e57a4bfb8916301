from .mxgraph import MinimizerGraph  # noqa: F401
