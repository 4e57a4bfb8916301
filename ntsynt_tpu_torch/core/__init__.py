from .assembly import AssemblyMinimizers, MxInfo, filter_common  # noqa: F401
from .blocks import Block, BlockSet  # noqa: F401
from .synteny import SyntenyDetector, SyntenyParams  # noqa: F401
