"""Device selection and the float32 rule.

Entry points run on ``cuda`` unless the caller asks for the CPU; with no
GPU they raise rather than quietly run on the CPU.  Under torchrun (one
process per GPU, ``parallel/dist.py``) ``cuda`` without an index is the
rank's own card, ``cuda:{LOCAL_RANK}``, which then becomes the process's
current device (NCCL places its communicator there); an explicit index is
kept as given and changes no process state: the kernels' wrappers and the
CUDA events launch and record on their tensors' card.

The float32 rule: on the card a float32 matrix product runs in full float32
only while ``torch.backends.cuda.matmul.allow_tf32`` is False, and a float32
convolution only while ``torch.backends.cudnn.allow_tf32`` is False (cuDNN
defaults to TF32, which keeps about three decimal digits).  The float32
path is the reference-parity path, so ``resolve_device`` turns both off for
the process whenever it hands out a CUDA device.  bfloat16 math is not
affected by either flag.
"""

from __future__ import annotations

import os

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; raises when CUDA is asked for and missing.

    Under torchrun's ``LOCAL_RANK`` and ``WORLD_SIZE``, ``cuda`` without an
    index is ``cuda:{LOCAL_RANK}``, and a ``LOCAL_RANK`` past the card
    count raises rather than wraps around, and the rank's card is made the
    current device."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' to "
                               "run on the CPU")
        if dev.index is None and "LOCAL_RANK" in os.environ \
                and "WORLD_SIZE" in os.environ:
            local = int(os.environ["LOCAL_RANK"])
            count = torch.cuda.device_count()
            if local >= count:
                raise RuntimeError(
                    f"LOCAL_RANK {local} has no card: this machine has "
                    f"{count}; launch at most {count} processes per node, "
                    f"or give each an explicit cuda:<index>")
            dev = torch.device("cuda", local)
            torch.cuda.set_device(dev)
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
