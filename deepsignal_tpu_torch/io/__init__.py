from . import fasta  # noqa: F401
from . import feature_codec  # noqa: F401
from . import calls_codec  # noqa: F401
