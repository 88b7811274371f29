"""Import the reference's TF1 checkpoints (port of
deepsignal_tpu/models/tf1_import.py).

The published model (``model.CpG.R9.4_1D.human_hx1.bn17.sn360``, README.md:88)
is a TF1 ``Saver`` checkpoint.  TensorFlow is not a dependency, so the
import takes two steps:

1. On a machine with TF1, dump the checkpoint to an .npz with
   ``TF1_EXPORT_SNIPPET`` below (name -> array, the graph's own names).
2. ``import_tf1_npz(npz_path, cfg)`` maps those arrays onto the flax-layout
   variable tree (numpy only), which ``train/checkpoints.py::save_checkpoint``
   writes as a checkpoint directory that both packages load, and
   ``import_tf1_state_dict`` carries into the port's state dict.

Weight layouts (deepsignal/model.py, deepsignal/layers.py):

- LSTM: ``tf.contrib.rnn.LSTMCell``'s kernel is [(D+H), 4H], gate order
  (i, j, f, o), zero bias, as in the port's encoder (both add the forget
  bias at run time), under
  ``<prefix>em/{fw,bw}/multi_rnn_cell/cell_<L>/lstm_cell/{kernel,bias}``.
- Conv2d kernels are [1, k, cin, cout] -> (k, cin, cout).
- contrib batch_norm's beta/gamma/moving_mean/moving_variance -> flax
  BatchNorm bias/scale and batch_stats mean/var.
- Joint_model's two ``tf.layers.dense`` calls make the top-level
  ``dense/kernel`` [6032, 6032] and ``dense_1/kernel`` [6032, 2]
  (layers.py:75-77 wraps them in a name scope only).
- The embedding table: ``<prefix>embedding`` [1024, 128] (model.py:61).

One deliberate difference from the JAX package: a ``tf.train.Saver``
checkpoint also holds Adam's slots (``<var>/Adam``, ``<var>/Adam_1``) and
``beta1_power``, ``beta2_power`` and ``global_step``.  The JAX importer
takes those for model variables and raises ("ambiguous"), and its dense
pattern also matches ``dense/kernel/Adam``.  Here they are dropped before
any name is matched, and the dense pattern is anchored at the name's end:
on a name space without them the result is the JAX package's, and on one
with them it is the result without them.
"""

from __future__ import annotations

import re
from typing import Optional

import numpy as np

from ..core.config import ModelConfig

TF1_EXPORT_SNIPPET = '''
# Run with TF1 installed (e.g. the reference's own environment):
import numpy as np, tensorflow as tf
ckpt = "model.CpG.R9.4_1D.human_hx1.bn17.sn360/bn_17.sn_360.epoch_9.ckpt"
reader = tf.train.NewCheckpointReader(ckpt)
arrs = {name: reader.get_tensor(name)
        for name, _ in tf.train.list_variables(ckpt)}
np.savez("deepsignal_tf1_weights.npz", **arrs)
'''

# what a tf.train.Saver checkpoint holds beside the model's variables
OPTIMIZER_SLOT_SUFFIXES = ("/Adam", "/Adam_1")
BOOKKEEPING_NAMES = ("beta1_power", "beta2_power", "global_step")
DENSE_KERNEL = re.compile(r"dense(_\d+)?/kernel$")


def model_arrays(arrs: dict) -> dict:
    """``arrs`` without optimizer slots and training bookkeeping (the
    published checkpoint prefixes its step counter: ``modelglobal_step``)."""
    return {k: v for k, v in arrs.items()
            if not k.endswith(OPTIMIZER_SLOT_SUFFIXES)
            and not k.rsplit("/", 1)[-1].endswith(BOOKKEEPING_NAMES)}


def _find(arrs: dict, *substrings, shape=None) -> Optional[str]:
    """The one name that contains every substring (and has ``shape`` when
    given); None when there is none, ValueError when there are several."""
    hits = [k for k in arrs
            if all(s in k for s in substrings)
            and (shape is None or tuple(arrs[k].shape) == tuple(shape))]
    if len(hits) == 1:
        return hits[0]
    if len(hits) > 1:
        raise ValueError(f"ambiguous TF1 variables for {substrings}: {hits}")
    return None


def _require(arrs: dict, *substrings, shape=None) -> np.ndarray:
    k = _find(arrs, *substrings, shape=shape)
    if k is None:
        raise KeyError(f"TF1 checkpoint missing variable matching "
                       f"{substrings} (shape {shape})")
    return np.asarray(arrs[k])


def _map_conv_bn(arrs: dict, conv_sel: tuple, bn_sel: tuple, params: dict,
                 stats: dict) -> None:
    """One conv (+ batch norm) pair, chosen by name substrings, into a
    ConvBNRelu module's ``Conv_0`` / ``BatchNorm_0`` entries."""
    kernel = _require(arrs, *conv_sel, "kernel")
    if kernel.ndim == 4:  # [1, k, cin, cout] -> (k, cin, cout)
        kernel = kernel[0]
    params["Conv_0"] = {"kernel": kernel}
    bn = {}
    bn_stats = {}
    for tf_name, ours, tree in (("beta", "bias", bn), ("gamma", "scale", bn),
                                ("moving_mean", "mean", bn_stats),
                                ("moving_variance", "var", bn_stats)):
        v = _find(arrs, *bn_sel, tf_name)
        if v is not None:
            tree[ours] = np.asarray(arrs[v])
    if bn:
        params["BatchNorm_0"] = bn
    if bn_stats:
        stats["BatchNorm_0"] = bn_stats


# TF branch scopes (layers.py:90-135): per branch, (conv name, the port's
# module name, the bn scope inside the branch).  Conv names are unique per
# block; bn scopes only within their branch scope.
_BRANCH_CONVS = [
    ("branch1_maxpooling", [("conv1a_1x1", "branch1_conv1a", "bn/")]),
    ("branch2_1x1", [("conv0b_1x1", "branch2_conv0b", "bn/")]),
    ("branch3_1x3", [("conv0c_1x1", "branch3_conv0c", "bn1/"),
                     ("conv1c_1x3", "branch3_conv1c", "bn2/")]),
    ("branch4_1x5", [("conv0d_1x1", "branch4_conv0d", "bn1/"),
                     ("conv1d_1x5", "branch4_conv1d", "bn2/")]),
    ("branch5_residual_1x3",
     [("convstem_1x1", "branch5_convstem", "bn0/"),
      ("conv0e_1x1", "branch5_conv0e", "bn1/"),
      ("conv1e_1x3", "branch5_conv1e", "bn2/"),
      ("conv2e_1x1", "branch5_conv2e", "bn3/")]),
]
_STEM_SCOPES = ("conv_layer1", "conv_layer2", "conv_layer3")


def import_tf1_arrays(arrs: dict, cfg: Optional[ModelConfig] = None) -> dict:
    """{tf1_name: array} -> ``{"params": ..., "batch_stats": ...}`` of numpy
    arrays in flax's layout, for ``DeepSignalNet(cfg)`` (default config
    when None)."""
    cfg = cfg or ModelConfig()
    arrs = model_arrays(arrs)
    params: dict = {}
    stats: dict = {}

    if cfg.is_rnn and cfg.is_base:
        params["embedding"] = _require(
            arrs, "embedding", shape=(cfg.vocab_size, cfg.embedding_size))

    if cfg.is_rnn:
        event: dict = {}
        for direction in ("fw", "bw"):
            for layer in range(cfg.lstm_layers):
                kernel = _require(arrs, f"/{direction}/",
                                  f"cell_{layer}/", "kernel")
                bias = _require(arrs, f"/{direction}/", f"cell_{layer}/",
                                "bias")
                event[f"{direction}_{layer}"] = {"kernel": kernel,
                                                 "bias": bias}
        params["event_model"] = event

    if cfg.is_cnn:
        sig_params: dict = {}
        sig_stats: dict = {}
        for scope in _STEM_SCOPES:
            p, s = {}, {}
            _map_conv_bn(arrs, (scope + "/", "conv/"),
                         (scope + "/", "bn/"), p, s)
            sig_params[scope] = p
            if s:
                sig_stats[scope] = s
        for i in range(1, sum(cfg.inception_blocks) + 1):
            blk_p: dict = {}
            blk_s: dict = {}
            for branch_scope, convs in _BRANCH_CONVS:
                for conv_name, our_name, bn_scope in convs:
                    p, s = {}, {}
                    # TF scope: incp_layer<i>/<scopestr><i><branch>/<conv>
                    _map_conv_bn(
                        arrs, (f"incp_layer{i}/", f"{conv_name}/"),
                        (f"incp_layer{i}/", branch_scope, bn_scope), p, s)
                    blk_p[our_name] = p
                    if s:
                        blk_s[our_name] = s
            sig_params[f"incp_layer{i}"] = blk_p
            if blk_s:
                sig_stats[f"incp_layer{i}"] = blk_s
        params["signal_model"] = sig_params
        if sig_stats:
            stats["signal_model"] = sig_stats

    # the joint head: the two dense kernels, told apart by shape
    dense_names = sorted(k for k in arrs if DENSE_KERNEL.search(k))
    if len(dense_names) < 2:
        raise KeyError("TF1 checkpoint missing joint-head dense kernels")
    fc1 = np.asarray(arrs[dense_names[0]])
    fc2 = np.asarray(arrs[dense_names[1]])
    if fc1.shape[1] == cfg.class_num:  # order swapped
        fc1, fc2 = fc2, fc1
    params["joint_model"] = {"fc1": {"kernel": fc1}, "fc2": {"kernel": fc2}}

    return {"params": params, "batch_stats": stats}


def import_tf1_state_dict(arrs: dict,
                          cfg: Optional[ModelConfig] = None) -> dict:
    """{tf1_name: array} -> the port's float32 state dict for
    ``DeepSignalNet(cfg)``; raises on any shape the config does not
    take."""
    from ..train.checkpoints import variables_to_state_dict
    cfg = cfg or ModelConfig()
    return variables_to_state_dict(cfg, import_tf1_arrays(arrs, cfg))


def import_tf1_npz(npz_path: str, cfg: Optional[ModelConfig] = None) -> dict:
    """A TF1-exported .npz (see ``TF1_EXPORT_SNIPPET``) -> variables."""
    with np.load(npz_path) as z:
        arrs = {k: z[k] for k in z.files}
    return import_tf1_arrays(arrs, cfg)


def export_tf1_style_arrays(variables: dict,
                            cfg: Optional[ModelConfig] = None) -> dict:
    """The inverse mapping: a variable tree -> {tf1_name: array}, for
    round-trip tests of the import and for reference-shaped dumps of
    models trained here."""
    cfg = cfg or ModelConfig()
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    arrs: dict = {}
    if "embedding" in params:
        arrs["modelembedding"] = np.asarray(params["embedding"])
    if "event_model" in params:
        for direction in ("fw", "bw"):
            for layer in range(cfg.lstm_layers):
                node = params["event_model"][f"{direction}_{layer}"]
                base = (f"modelem/{direction}/multi_rnn_cell/cell_{layer}/"
                        f"lstm_cell/")
                arrs[base + "kernel"] = np.asarray(node["kernel"])
                arrs[base + "bias"] = np.asarray(node["bias"])
    if "signal_model" in params:
        sp = params["signal_model"]
        ss = stats.get("signal_model", {})

        def put(branch_prefix, conv_name, bn_scope, node_p, node_s):
            arrs[branch_prefix + conv_name + "kernel"] = \
                np.asarray(node_p["Conv_0"]["kernel"])[None]
            if "BatchNorm_0" in node_p:
                arrs[branch_prefix + bn_scope + "beta"] = \
                    np.asarray(node_p["BatchNorm_0"]["bias"])
                arrs[branch_prefix + bn_scope + "gamma"] = \
                    np.asarray(node_p["BatchNorm_0"]["scale"])
            if node_s and "BatchNorm_0" in node_s:
                arrs[branch_prefix + bn_scope + "moving_mean"] = \
                    np.asarray(node_s["BatchNorm_0"]["mean"])
                arrs[branch_prefix + bn_scope + "moving_variance"] = \
                    np.asarray(node_s["BatchNorm_0"]["var"])

        for scope in _STEM_SCOPES:
            put(f"modelsignalm{scope}/", "conv/", "bn/", sp[scope],
                ss.get(scope, {}))
        for i in range(1, sum(cfg.inception_blocks) + 1):
            for branch_scope, convs in _BRANCH_CONVS:
                for conv_name, our_name, bn_scope in convs:
                    put(f"modelsignalmincp_layer{i}/modelsignalm{i}"
                        f"{branch_scope}/", f"{conv_name}/", bn_scope,
                        sp[f"incp_layer{i}"][our_name],
                        ss.get(f"incp_layer{i}", {}).get(our_name, {}))
    arrs["dense/kernel"] = np.asarray(
        params["joint_model"]["fc1"]["kernel"])
    arrs["dense_1/kernel"] = np.asarray(
        params["joint_model"]["fc2"]["kernel"])
    return arrs
