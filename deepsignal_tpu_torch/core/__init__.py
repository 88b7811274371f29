from . import constants  # noqa: F401
from . import config  # noqa: F401
