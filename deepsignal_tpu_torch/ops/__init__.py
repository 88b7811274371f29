"""The LSTM's plain versions (``bilstm``) and its CUDA kernels (``cuda``).

``bilstm`` is imported at first access: ``io/native.py`` reaches this
package for its build helper (``cuda/build.py``), and the spawned extract
workers and reader process, which import ``io``, must not pay for torch.
"""

import importlib


def __getattr__(name):
    if name == "bilstm":
        return importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(name)
