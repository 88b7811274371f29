"""The port's DeepSignalNet against the flax model (both encoder paths) and,
layer by layer, against the float64 numpy oracle of tests/net_oracle.py, on
tiny configs with the full encoder depth (3 layers, hidden 128, so the fused
encoder path is taken)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from deepsignal_tpu.core.config import ModelConfig as JaxModelConfig
from deepsignal_tpu.models.deepsignal import DeepSignalNet as FlaxNet
from deepsignal_tpu_torch.core.config import ModelConfig
from deepsignal_tpu_torch.models.deepsignal import (DeepSignalNet,
                                                    normalized_probs,
                                                    predictions)
from deepsignal_tpu_torch.models.layers import tf_same_pads
from deepsignal_tpu_torch.train.checkpoints import state_dict_to_variables
from tests.net_oracle import oracle_forward

torch.set_num_threads(1)

TOL = 1e-5  # float32 against float32 (flax) or float64 (oracle)
B = 8
TINY = dict(lstm_hidden=128, lstm_layers=3, inception_times=1,
            inception_blocks=(1, 1, 1), kmer_len=5)
MODES = {"full": {}, "rnn_only": dict(is_cnn=False),
         "cnn_only": dict(is_rnn=False), "rnn_nobase": dict(is_base=False)}


def _batch(rng, k, s):
    return dict(
        kmer=rng.integers(0, 5, (B, k)).astype(np.int32),
        means=rng.normal(0, 1, (B, k)).astype(np.float32),
        stds=(np.abs(rng.normal(0, 0.5, (B, k))) + 0.05).astype(np.float32),
        sanums=rng.integers(1, 40, (B, k)).astype(np.float32),
        signals=rng.normal(0, 1, (B, s)).round(6).astype(np.float32))


_SETUPS = {}


def _setup(mode, signal_len):
    """(jax cfg, port model, flax variables, batch) for (mode, signal_len),
    built once.  Weights come from the port's seeded init, with biases and
    batch-norm statistics moved away from their init values, and go to
    flax through the checkpoint bridge (no flax init compile)."""
    key = (mode, signal_len)
    if key not in _SETUPS:
        cfg = ModelConfig(cent_signals_len=signal_len, **TINY, **MODES[mode])
        torch.manual_seed(signal_len)
        model = DeepSignalNet(cfg).eval()
        rng = np.random.default_rng(signal_len)
        with torch.no_grad():
            for name, t in model.state_dict().items():
                leaf = name.rsplit(".", 1)[-1]
                if leaf in ("bias", "mean"):
                    t.copy_(torch.from_numpy(rng.normal(0, 0.3, t.shape)))
                elif leaf in ("scale", "var"):
                    t.copy_(torch.from_numpy(rng.uniform(0.5, 2.0, t.shape)))
        variables = state_dict_to_variables(cfg, model.state_dict())
        jax_cfg = JaxModelConfig(**dataclasses.asdict(cfg), lstm_impl="xla")
        _SETUPS[key] = (jax_cfg, model, variables,
                        _batch(rng, cfg.kmer_len, signal_len))
    return _SETUPS[key]


def _port_logits(model, batch):
    with torch.inference_mode():
        return model(*(torch.from_numpy(batch[k]) for k in
                       ("kmer", "means", "stds", "sanums", "signals"))).numpy()


def _flax_logits(cfg, variables, batch):
    model = FlaxNet(cfg)
    fwd = jax.jit(lambda v, b: model.apply(v, **b, train=False))
    return np.asarray(fwd(variables, batch))


def test_tf_same_pads_put_the_extra_pad_right():
    assert tf_same_pads(360, 7, 2) == (2, 3)   # conv_layer1
    assert tf_same_pads(180, 3, 2) == (0, 1)   # stage max-pool
    assert tf_same_pads(24, 7, 2) == (2, 3)
    assert tf_same_pads(25, 7, 2) == (3, 3)
    assert tf_same_pads(23, 7, 1) == (3, 3)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("signal_len", [24, 25])
def test_model_matches_flax(impl, signal_len):
    cfg, model, variables, batch = _setup("full", signal_len)
    with jax.default_matmul_precision("highest"):
        want = _flax_logits(dataclasses.replace(cfg, lstm_impl=impl),
                            variables, batch)
    got = _port_logits(model, batch)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("mode", ["rnn_only", "cnn_only", "rnn_nobase"])
def test_ablation_modes_match_flax(mode):
    cfg, model, variables, batch = _setup(mode, 24)
    with jax.default_matmul_precision("highest"):
        want = _flax_logits(cfg, variables, batch)
    got = _port_logits(model, batch)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("signal_len", [24, 25])
def test_model_matches_oracle_layer_by_layer(signal_len):
    cfg, model, variables, batch = _setup("full", signal_len)
    oracle = oracle_forward(variables, **batch,
                            inception_blocks=cfg.inception_blocks,
                            lstm_layers=cfg.lstm_layers)
    acts = {}
    names = ["event_model", "signal_model", "signal_model/conv_layer1",
             "signal_model/conv_layer2", "signal_model/conv_layer3"] + [
        f"signal_model/incp_layer{i}" for i in (1, 2, 3)]
    hooks = []
    for name in names:
        def hook(module, args, out, name=name):
            # [B, C, L] -> the oracle's [B, L, C]
            acts[name] = (out.transpose(1, 2) if out.dim() == 3 else out)
        hooks.append(model.get_submodule(name.replace("/", "."))
                     .register_forward_hook(hook))
    logits = _port_logits(model, batch)
    for h in hooks:
        h.remove()
    for name in names:
        np.testing.assert_allclose(acts[name].numpy(),
                                   oracle[name].astype(np.float32),
                                   rtol=TOL, atol=TOL, err_msg=name)
    np.testing.assert_allclose(logits, oracle["logits"].astype(np.float32),
                               rtol=TOL, atol=TOL)
    p0, p1 = normalized_probs(torch.from_numpy(logits))
    np.testing.assert_allclose(p1.numpy(), oracle["prob_1"], atol=TOL)
    np.testing.assert_array_equal(predictions(torch.from_numpy(logits)),
                                  oracle["prediction"])


def test_bf16_model_tracks_flax_bf16():
    cfg, model, variables, batch = _setup("full", 24)
    want = _flax_logits(dataclasses.replace(cfg, compute_dtype="bfloat16",
                                            matmul_precision="default",
                                            lstm_impl="pallas"),
                        variables, batch)
    model16 = DeepSignalNet(dataclasses.replace(model.cfg,
                                                compute_dtype="bfloat16"))
    model16.load_state_dict(model.state_dict())
    got = _port_logits(model16.eval(), batch)
    # bfloat16 keeps 8 mantissa bits; logits here are O(1)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-2)
