"""TF1 checkpoint import and the profiling hooks of the port, against the
JAX package.

On the published model's name space (tests/fixtures/
tf1_variables_bn17_sn360.json, 581 variables) with seeded values, the
port's import gives the JAX package's variable tree and state dict
exactly.  With the optimizer slots and bookkeeping variables of a
``tf.train.Saver`` checkpoint added, the port gives the same state dict
while the JAX importer raises: a known, intended difference (ROADMAP Queue
C).  The imported model reproduces the raw-array TF1 forward of
tests/test_tf1_value_parity.py, and each of that file's four value-level
corruptions breaks the agreement."""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from deepsignal_tpu.core import logging as jax_logging
from deepsignal_tpu.core.config import ModelConfig as JaxModelConfig
from deepsignal_tpu.models import tf1_import as jax_tf1
from deepsignal_tpu.models.deepsignal import DeepSignalNet as FlaxNet
from deepsignal_tpu.train.checkpoints import \
    load_checkpoint as jax_load_checkpoint
from deepsignal_tpu_torch.core import logging
from deepsignal_tpu_torch.core.config import ModelConfig
from deepsignal_tpu_torch.models import tf1_import
from deepsignal_tpu_torch.models.deepsignal import model_from_state_dict
from deepsignal_tpu_torch.runtime.caller import run_call_mods
from deepsignal_tpu_torch.train.checkpoints import (load_checkpoint,
                                                    save_checkpoint,
                                                    state_dict_to_variables,
                                                    variables_to_state_dict)
from tests import torch_tiny
from tests.test_tf1_value_parity import _synth_checkpoint, tf1_forward_raw

torch.set_num_threads(1)

N_VARIABLES = 581
FWD_TOL = 1e-5      # float32 port against float32 flax
ORACLE_TOL = 2e-3   # float32 against the float64 oracle (as the JAX test)
DIVERGED = 0.02     # an order of magnitude above ORACLE_TOL


def with_saver_slots(arrs: dict) -> dict:
    """``arrs`` plus what a ``tf.train.Saver`` of an Adam run also stores:
    ``<var>/Adam`` and ``<var>/Adam_1`` for every variable (same shapes and
    dtypes, other values) and ``beta1_power``, ``beta2_power``,
    ``global_step``."""
    out = dict(arrs)
    for name, a in arrs.items():
        out[f"{name}/Adam"] = a + 1
        out[f"{name}/Adam_1"] = a * a
    out["beta1_power"] = np.float32(0.9 ** 1000)
    out["beta2_power"] = np.float32(0.999 ** 1000)
    out["global_step"] = np.int64(1000)
    return out


def _equal_trees(a, b) -> bool:
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            _equal_trees(a[k], b[k]) for k in a)
    return (np.asarray(a).dtype == np.asarray(b).dtype
            and np.array_equal(a, b))


def _equal_state_dicts(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(
        a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]) for k in a)


@pytest.fixture(scope="module")
def published():
    arrs = _synth_checkpoint()
    assert len(arrs) == N_VARIABLES
    return arrs, ModelConfig()


def test_import_equals_jax_on_the_published_name_space(published):
    arrs, cfg = published
    tree = tf1_import.import_tf1_arrays(arrs, cfg)
    want = jax_tf1.import_tf1_arrays(arrs, JaxModelConfig())
    assert _equal_trees(tree, want)
    sd = tf1_import.import_tf1_state_dict(arrs, cfg)
    assert _equal_state_dicts(sd, variables_to_state_dict(cfg, want))
    assert len(sd) == N_VARIABLES - 1  # all but modelglobal_step


def test_saver_slots_are_dropped_where_the_jax_importer_raises(published):
    arrs, cfg = published
    slotted = with_saver_slots(arrs)
    assert len(slotted) == 3 * N_VARIABLES + 3
    assert tf1_import.model_arrays(slotted).keys() == \
        tf1_import.model_arrays(arrs).keys() == \
        arrs.keys() - {"modelglobal_step"}
    assert _equal_state_dicts(tf1_import.import_tf1_state_dict(slotted, cfg),
                              tf1_import.import_tf1_state_dict(arrs, cfg))
    # the recorded difference: the JAX importer takes the slots for model
    # variables and raises
    with pytest.raises(ValueError, match="ambiguous TF1 variables"):
        jax_tf1.import_tf1_arrays(slotted, JaxModelConfig())


def test_the_dense_pattern_is_anchored_at_the_name_end(published):
    """The JAX pattern also matches ``dense/kernel/Adam``; the port's takes
    the kernels only, so a slot that sorts first cannot become fc1."""
    arrs, cfg = published
    names = list(arrs) + ["dense/kernel/Adam", "dense_1/kernel/Adam_1",
                          "dense/kernel/ExponentialMovingAverage"]
    assert sorted(n for n in names
                  if tf1_import.DENSE_KERNEL.search(n)) == \
        ["dense/kernel", "dense_1/kernel"]


def _tiny_tf1_arrays():
    cfg = torch_tiny.tiny_cfg()
    return cfg, tf1_import.export_tf1_style_arrays(
        state_dict_to_variables(cfg, torch_tiny.tiny_state_dict()), cfg)


def test_npz_import_and_checkpoint_load_in_both_packages(tmp_path):
    """A slot-bearing .npz -> ``import_tf1_npz`` -> ``save_checkpoint``:
    the directory loads in both packages to the slot-free state dict."""
    cfg, arrs = _tiny_tf1_arrays()
    npz = tmp_path / "tf1.npz"
    np.savez(npz, **with_saver_slots(arrs))
    variables = tf1_import.import_tf1_npz(str(npz), cfg)
    ckpt = save_checkpoint(str(tmp_path / "bn_5.sn_25.epoch_0.ckpt"), cfg,
                           variables)
    want = tf1_import.import_tf1_state_dict(arrs, cfg)
    got_cfg, got = load_checkpoint(ckpt)
    assert got_cfg == cfg
    assert _equal_state_dicts(variables_to_state_dict(cfg, got), want)
    jax_cfg, jax_vars = jax_load_checkpoint(ckpt)
    assert jax_cfg.lstm_hidden == cfg.lstm_hidden
    assert _equal_state_dicts(variables_to_state_dict(cfg, jax_vars), want)


def test_export_import_round_trip(published):
    arrs, cfg = published
    tree = tf1_import.import_tf1_arrays(arrs, cfg)
    exported = tf1_import.export_tf1_style_arrays(tree, cfg)
    assert _equal_trees(exported,
                        jax_tf1.export_tf1_style_arrays(tree,
                                                        JaxModelConfig()))
    assert _equal_trees(exported, tf1_import.model_arrays(arrs))
    assert _equal_trees(tf1_import.import_tf1_arrays(exported, cfg), tree)


def test_tiny_forward_on_tf1_arrays_matches_jax():
    """TF1-named arrays of the tiny model, imported by each package and
    run forward in float32: the logits agree within FWD_TOL."""
    cfg, arrs = _tiny_tf1_arrays()
    arrs = with_saver_slots(arrs)
    model = model_from_state_dict(
        cfg, tf1_import.import_tf1_state_dict(arrs, cfg),
        torch.device("cpu"))
    batch = _batch(np.random.default_rng(81), 16, cfg)
    with torch.inference_mode():
        got = model(*(torch.from_numpy(batch[k]) for k in
                      ("kmer", "means", "stds", "sanums",
                       "signals"))).numpy()
    jax_cfg = JaxModelConfig(**dataclasses.asdict(cfg), lstm_impl="xla")
    variables = jax_tf1.import_tf1_arrays(
        tf1_import.model_arrays(arrs), jax_cfg)
    flax = FlaxNet(jax_cfg)
    want = np.asarray(jax.jit(lambda v, b: flax.apply(v, **b, train=False))(
        variables, batch))
    assert np.isfinite(got).all() and np.abs(got).max() > 0.1
    np.testing.assert_allclose(got, want, rtol=0, atol=FWD_TOL)


def _batch(rng, n, cfg):
    k, s = cfg.kmer_len, cfg.cent_signals_len
    return dict(kmer=rng.integers(0, 4, (n, k)).astype(np.int32),
                means=rng.normal(0, 1, (n, k)).astype(np.float32),
                stds=np.abs(rng.normal(0, 1, (n, k))).astype(np.float32),
                sanums=rng.integers(1, 40, (n, k)).astype(np.float32),
                signals=rng.normal(0, 1, (n, s)).astype(np.float32))


@pytest.fixture(scope="module")
def oracle(published):
    """The raw-array TF1 forward of the published name space on a batch
    of 2 (float64, tests/test_tf1_value_parity.py), and the port's forward
    of an imported, possibly corrupted, copy."""
    arrs, cfg = published
    batch = _batch(np.random.default_rng(11), 2, cfg)

    def port_forward(a):
        model = model_from_state_dict(
            cfg, tf1_import.import_tf1_state_dict(a, cfg),
            torch.device("cpu"))
        with torch.inference_mode():
            return model(*(torch.from_numpy(batch[k]) for k in
                           ("kmer", "means", "stds", "sanums",
                            "signals"))).double().numpy()

    return tf1_forward_raw(arrs, **batch), port_forward


def test_import_reproduces_the_tf1_forward(published, oracle):
    arrs, _ = published
    want, port_forward = oracle
    got = port_forward(with_saver_slots(arrs))
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got, want, rtol=ORACLE_TOL, atol=ORACLE_TOL)


def _lstm_gate_reorder(arrs):
    out = dict(arrs)
    for direction in ("fw", "bw"):
        for layer in range(3):
            base = f"modelem/{direction}/multi_rnn_cell/cell_{layer}/lstm_cell/"
            h = arrs[base + "kernel"].shape[1] // 4
            perm = np.concatenate([np.arange(0, h), np.arange(2 * h, 3 * h),
                                   np.arange(h, 2 * h),
                                   np.arange(3 * h, 4 * h)])
            out[base + "kernel"] = np.ascontiguousarray(
                arrs[base + "kernel"][:, perm])
            out[base + "bias"] = np.ascontiguousarray(
                arrs[base + "bias"][perm])
    return out


def _fw_bw_swap(arrs):
    out = dict(arrs)
    for layer in range(3):
        for leaf in ("kernel", "bias"):
            f = f"modelem/fw/multi_rnn_cell/cell_{layer}/lstm_cell/{leaf}"
            b = f"modelem/bw/multi_rnn_cell/cell_{layer}/lstm_cell/{leaf}"
            out[f], out[b] = arrs[b], arrs[f]
    return out


def _bn_mean_var_swap(arrs):
    out = dict(arrs)
    m = "modelsignalmconv_layer1/bn/moving_mean"
    v = "modelsignalmconv_layer1/bn/moving_variance"
    out[m], out[v] = arrs[v], arrs[m]
    return out


def _fc1_transpose(arrs):
    return {**arrs, "dense/kernel": np.ascontiguousarray(
        arrs["dense/kernel"].T)}


@pytest.mark.parametrize("corrupt", [_fc1_transpose, _lstm_gate_reorder,
                                     _fw_bw_swap, _bn_mean_var_swap])
def test_value_level_corruptions_break_agreement(published, oracle,
                                                 corrupt):
    arrs, _ = published
    want, port_forward = oracle
    got = port_forward(corrupt(arrs))
    assert not np.isfinite(got).all() or \
        float(np.abs(got - want).max()) > DIVERGED, corrupt.__name__


# --------------------------------------------------------------------------
# profiling hooks


def test_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    with logging.trace(None) as path:
        assert path is None
    with logging.trace(str(tmp_path / "prof"), "cpu") as path:
        torch.ones(64, 64) @ torch.ones(64, 64)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert os.path.dirname(path) == str(tmp_path / "prof")
    assert any(e.get("name") == "aten::matmul" for e in events)


def test_stage_timer_summary_is_the_jax_text():
    port, jax_timer = logging.StageTimer(), jax_logging.StageTimer()
    for timer in (port, jax_timer):
        with timer.stage("forward"):
            pass
        timer.totals.update(read_wait=1.25, forward=3.5, format=0.004)
    assert port.summary() == jax_timer.summary() == (
        "stage timing: forward: 3.50s (74%), read_wait: 1.25s (26%), "
        "format: 0.00s (0%)")
    assert logging.StageTimer().summary() == \
        jax_logging.StageTimer().summary() == "stage timing: "


def test_run_call_mods_writes_a_trace(tmp_path):
    cfg = torch_tiny.tiny_cfg()
    ckpt = save_checkpoint(
        str(tmp_path / "m.ckpt"), cfg,
        state_dict_to_variables(cfg, torch_tiny.tiny_state_dict()))
    for profile_dir in (None, str(tmp_path / "prof")):
        out = tmp_path / f"calls{profile_dir is None}.tsv"
        n = run_call_mods(torch_tiny.FEATURES, ckpt, str(out),
                          batch_size=16, compute_dtype="float32",
                          device="cpu", profile_dir=profile_dir)
        assert n == torch_tiny.N_ROWS
    assert (tmp_path / "callsTrue.tsv").read_bytes() == \
        (tmp_path / "callsFalse.tsv").read_bytes()
    traces = os.listdir(tmp_path / "prof")
    assert len(traces) == 1 and traces[0].endswith(".pt.trace.json")
    with open(tmp_path / "prof" / traces[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "aten::linear" in names or "aten::addmm" in names
