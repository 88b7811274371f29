from . import signal  # noqa: F401
from . import central  # noqa: F401
