"""Model checkpoints in the JAX package's on-disk format.

A checkpoint is a directory (deepsignal_tpu/train/checkpoints.py:62-102):

- ``config.json``       the ModelConfig fields
- ``variables.msgpack`` flax-serialized ``{"params": ..., "batch_stats": ...}``
- ``meta.json``         epoch / metric bookkeeping (optional)

``load_checkpoint`` returns the variables as the nested dict of numpy arrays
that flax wrote; ``variables_to_state_dict`` carries them into the port's
``DeepSignalNet``, and ``state_dict_to_variables`` back.  Layouts:

- flax Conv ``[K, Cin, Cout]``  <->  ``<module>.weight`` ``[Cout, Cin, K]``
- flax Dense ``[in, out]``      <->  ``<module>.weight`` ``[out, in]``
- LSTM kernels keep the TF layout ``[(D+H), 4H]``, gate order i, j, f, o
- ``BatchNorm_0`` scale/bias (params) and mean/var (batch_stats) <->
  ``<module>.bn.{scale,bias,mean,var}``
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional, Tuple

import numpy as np

from ..core.config import ModelConfig
from ..io.msgpack import restore_tree, serialize_tree

DENSE_PREFIX = "joint_model."


def ckpt_name(kmer_len: int, signal_len: int, epoch: int) -> str:
    return f"bn_{kmer_len}.sn_{signal_len}.epoch_{epoch}.ckpt"


def save_checkpoint(path: str, cfg: ModelConfig, variables,
                    meta: Optional[dict] = None) -> str:
    """Write ``variables`` (nested dict of numpy arrays) and ``cfg``."""
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(dataclasses.asdict(cfg), f, indent=1)
    with open(os.path.join(path, "variables.msgpack"), "wb") as f:
        f.write(serialize_tree(variables))
    if meta is not None:
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump(meta, f, indent=1)
    return path


def load_checkpoint(path: str, cfg: Optional[ModelConfig] = None
                    ) -> Tuple[ModelConfig, dict]:
    """(cfg, variables) of a checkpoint directory; ``cfg`` overrides the
    stored config."""
    with open(os.path.join(path, "config.json")) as f:
        loaded_cfg = ModelConfig.from_dict(json.load(f))
    with open(os.path.join(path, "variables.msgpack"), "rb") as f:
        variables = restore_tree(f.read())
    return (cfg if cfg is not None else loaded_cfg), variables


def _flatten(tree, prefix=()):
    for key, sub in tree.items():
        if isinstance(sub, dict):
            yield from _flatten(sub, prefix + (key,))
        else:
            yield prefix + (key,), sub


def _torch_name(path: tuple):
    """flax leaf path -> (state-dict name, layout permutation or None)."""
    *mods, leaf = path
    if mods and mods[-1] == "Conv_0" and leaf == "kernel":
        return ".".join(mods[:-1] + ["weight"]), (2, 1, 0)
    if mods and mods[-1] == "BatchNorm_0":
        return ".".join(mods[:-1] + ["bn", leaf]), None
    name = ".".join(path)
    if name.startswith(DENSE_PREFIX) and leaf == "kernel":
        return ".".join(mods + ["weight"]), (1, 0)
    return name, None


def _flax_path(name: str):
    """state-dict name -> (collection, flax leaf path, permutation)."""
    parts = name.split(".")
    if len(parts) >= 2 and parts[-2] == "bn":
        coll = "batch_stats" if parts[-1] in ("mean", "var") else "params"
        return coll, tuple(parts[:-2]) + ("BatchNorm_0", parts[-1]), None
    if parts[-1] == "weight":
        if name.startswith(DENSE_PREFIX):
            return "params", tuple(parts[:-1]) + ("kernel",), (1, 0)
        return "params", tuple(parts[:-1]) + ("Conv_0", "kernel"), (2, 1, 0)
    return "params", tuple(parts), None


def _expected_shapes(cfg: ModelConfig) -> dict:
    import torch

    from ..models.deepsignal import DeepSignalNet
    with torch.device("meta"):
        model = DeepSignalNet(cfg)
    return {k: tuple(v.shape) for k, v in model.state_dict().items()}


def _check_shapes(cfg: ModelConfig, shapes: dict) -> None:
    want = _expected_shapes(cfg)
    if want.keys() != shapes.keys():
        missing = sorted(want.keys() - shapes.keys())
        extra = sorted(shapes.keys() - want.keys())
        raise ValueError(f"checkpoint does not match the config: missing "
                         f"{missing[:5]}, unexpected {extra[:5]}")
    for k, shape in shapes.items():
        if tuple(shape) != want[k]:
            raise ValueError(f"{k}: checkpoint shape {tuple(shape)}, model "
                             f"wants {want[k]}")


def variables_to_state_dict(cfg: ModelConfig, variables) -> dict:
    """flax variables -> {name: float32 numpy array} for
    ``DeepSignalNet(cfg).load_state_dict``.  Raises on any mismatch."""
    sd = {}
    for coll in ("params", "batch_stats"):
        for path, arr in _flatten(variables.get(coll, {})):
            name, perm = _torch_name(path)
            arr = np.asarray(arr)  # a read-only view of the file: copy
            sd[name] = np.array(arr.transpose(perm) if perm else arr,
                                dtype=np.float32, order="C")
    _check_shapes(cfg, {k: v.shape for k, v in sd.items()})
    return sd


def state_dict_to_variables(cfg: ModelConfig, state_dict) -> dict:
    """Inverse of ``variables_to_state_dict``: ``{name: array or tensor}``
    -> ``{"params": ..., "batch_stats": ...}`` of float32 numpy arrays."""
    sd = {k: np.asarray(v.detach().cpu() if hasattr(v, "detach") else v,
                        dtype=np.float32) for k, v in state_dict.items()}
    _check_shapes(cfg, {k: v.shape for k, v in sd.items()})
    variables = {"params": {}, "batch_stats": {}}
    for name, arr in sd.items():
        coll, path, perm = _flax_path(name)
        node = variables[coll]
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = np.ascontiguousarray(
            arr.transpose(perm) if perm else arr)
    if not variables["batch_stats"]:
        del variables["batch_stats"]
    return variables
