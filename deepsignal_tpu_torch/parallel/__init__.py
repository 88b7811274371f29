"""Process groups (``dist``) and the (data, model) mesh over them
(``mesh``).

``mesh`` is imported at first access: the spawned extract workers and
reader process import ``dist`` for the host shard's file list and must not
pay for torch.
"""

import importlib


def __getattr__(name):
    if name == "mesh":
        return importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(name)
