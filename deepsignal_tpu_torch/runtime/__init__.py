"""The scoring engine (``caller``) and the host processes that feed it
(``pipeline``).

Both are imported at first access: the spawned extract workers and reader
process import ``pipeline`` alone and must not pay for the engine's import
(torch and the model).
"""

import importlib


def __getattr__(name):
    if name in ("caller", "pipeline"):
        return importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(name)
