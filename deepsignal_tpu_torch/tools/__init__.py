from . import frequency  # noqa: F401
from . import dataset  # noqa: F401
