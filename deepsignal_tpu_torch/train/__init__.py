from . import checkpoints  # noqa: F401
