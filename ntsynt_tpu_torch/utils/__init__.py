from .log import log, set_verbose
from .timer import StageTimer
