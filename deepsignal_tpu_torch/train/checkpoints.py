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

Training adds the reference's naming and clean-up of checkpoints
(train_model.py:33-47) and a rolling ``train_state.ckpt`` directory for
exact resume (deepsignal_tpu/train/checkpoints.py:105-166): a checkpoint
whose ``variables.msgpack`` is in flax's layout (so either package loads
it), plus ``train_state.msgpack`` with the optimizer and generator state in
the port's own tree.  A train state written by one package does not resume
in the other.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
from typing import Optional, Tuple

import numpy as np

from ..core.config import ModelConfig
from ..io.msgpack import restore_tree, serialize_tree

DENSE_PREFIX = "joint_model."


def ckpt_name(kmer_len: int, signal_len: int, epoch: int) -> str:
    return f"bn_{kmer_len}.sn_{signal_len}.epoch_{epoch}.ckpt"


def ckpt_regex(kmer_len: int, signal_len: int) -> re.Pattern:
    return re.compile(r"bn_" + str(kmer_len) + r"\.sn_" + str(signal_len)
                      + r"\.epoch_\d+\.ckpt*")


def clean_model_dir(model_dir: str, kmer_len: int, signal_len: int) -> int:
    """Delete pre-existing checkpoints matching the naming scheme
    (train_model.py:37-47); returns the number removed."""
    if not os.path.exists(model_dir):
        os.makedirs(model_dir)
        return 0
    regex = ckpt_regex(kmer_len, signal_len)
    count = 0
    for mfile in os.listdir(model_dir):
        if regex.match(mfile) or mfile == "checkpoint":
            full = os.path.join(model_dir, mfile)
            if os.path.isdir(full):
                shutil.rmtree(full)
            else:
                os.remove(full)
            count += 1
    return count


def latest_checkpoint(model_dir: str, kmer_len: int,
                      signal_len: int) -> Optional[str]:
    """Highest-epoch checkpoint in a model dir, or None."""
    regex = ckpt_regex(kmer_len, signal_len)
    best, best_epoch = None, -1
    if not os.path.isdir(model_dir):
        return None
    for mfile in os.listdir(model_dir):
        if regex.match(mfile):
            epoch = int(mfile.split(".epoch_")[1].split(".")[0])
            if epoch > best_epoch:
                best, best_epoch = mfile, epoch
    return os.path.join(model_dir, best) if best else None


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


TRAIN_STATE_DIRNAME = "train_state.ckpt"


def save_train_state(model_dir: str, cfg: ModelConfig, variables, train_state,
                     meta: dict) -> str:
    """Write the rolling full-train-state checkpoint (atomic via tmp +
    rename): a checkpoint of ``variables`` with ``meta`` (the loop's
    json-serializable bookkeeping), plus ``train_state.msgpack`` holding
    ``train_state``, a nested dict of numpy arrays (optimizer and generator
    state)."""
    path = os.path.join(model_dir, TRAIN_STATE_DIRNAME)
    tmp = path + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    save_checkpoint(tmp, cfg, variables, meta=meta)
    with open(os.path.join(tmp, "train_state.msgpack"), "wb") as f:
        f.write(serialize_tree(train_state))
    if os.path.exists(path):
        shutil.rmtree(path)
    os.rename(tmp, path)
    return path


def load_train_state(model_dir: str):
    """(cfg, variables, train_state, meta) of the rolling train-state
    checkpoint, or None when there is none."""
    path = os.path.join(model_dir, TRAIN_STATE_DIRNAME)
    if not os.path.isdir(path):
        return None
    cfg, variables = load_checkpoint(path)
    with open(os.path.join(path, "train_state.msgpack"), "rb") as f:
        train_state = restore_tree(f.read())
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    return cfg, variables, train_state, meta


def clear_train_state(model_dir: str) -> None:
    path = os.path.join(model_dir, TRAIN_STATE_DIRNAME)
    if os.path.isdir(path):
        shutil.rmtree(path)
