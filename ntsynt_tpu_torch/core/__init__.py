from .assembly import AssemblyMinimizers, filter_common  # noqa: F401
from .blocks import Block, BlockSet  # noqa: F401
from .synteny import SyntenyDetector, SyntenyParams  # noqa: F401
