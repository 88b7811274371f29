"""Device selection and the float32 rule.

Entry points run on ``cuda`` unless the caller asks for the CPU; with no
GPU they raise rather than quietly run on the CPU.

The float32 rule: on the card a float32 matrix product runs in full float32
only while ``torch.backends.cuda.matmul.allow_tf32`` is False, and a float32
convolution only while ``torch.backends.cudnn.allow_tf32`` is False (cuDNN
defaults to TF32, which keeps about three decimal digits).  The float32
path is the reference-parity path, so ``resolve_device`` turns both off for
the process whenever it hands out a CUDA device.  bfloat16 math is not
affected by either flag.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; raises when CUDA is asked for and missing."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' to "
                               "run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def torch_dtype(name: str) -> torch.dtype:
    """``"float32"`` / ``"bfloat16"`` -> the torch dtype."""
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    if name not in dtypes:
        raise ValueError(f"compute dtype must be one of {sorted(dtypes)}, "
                         f"got {name!r}")
    return dtypes[name]
