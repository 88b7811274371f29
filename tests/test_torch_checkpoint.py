"""The port's checkpoint bridge and msgpack codec against deepsignal_tpu and
flax: same on-disk format both ways, state-dict layouts, byte-identical
msgpack."""

import dataclasses

import flax.serialization
import msgpack as msgpack_pkg
import numpy as np
import pytest
import torch

from deepsignal_tpu.core.config import ModelConfig as JaxModelConfig
from deepsignal_tpu.models.deepsignal import init_model
from deepsignal_tpu.train import checkpoints as jax_ckpt
from deepsignal_tpu_torch.core.config import ModelConfig
from deepsignal_tpu_torch.io import msgpack
from deepsignal_tpu_torch.models.deepsignal import DeepSignalNet
from deepsignal_tpu_torch.train import checkpoints as ckpt

torch.set_num_threads(1)

TINY = dict(lstm_hidden=8, lstm_layers=1, inception_times=1,
            inception_blocks=(1, 1, 1), cent_signals_len=24, kmer_len=5)


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


@pytest.fixture(scope="module")
def jax_variables():
    _, variables = init_model(JaxModelConfig(**TINY))
    rng = np.random.default_rng(5)
    # batch stats away from their init values, so a swapped mean/var shows
    stats = {p: rng.uniform(0.5, 2.0, a.shape).astype(np.float32)
             for p, a in _leaves(variables["batch_stats"])}
    out = {"params": variables["params"], "batch_stats": {}}
    for path, a in stats.items():
        node = out["batch_stats"]
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = a
    return out


def _assert_same_tree(got, want):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=str(k))


def test_jax_checkpoint_loads_in_port(tmp_path, jax_variables):
    path = jax_ckpt.save_checkpoint(str(tmp_path / "ck"),
                                    JaxModelConfig(**TINY), jax_variables)
    cfg, variables = ckpt.load_checkpoint(path)
    assert cfg == ModelConfig(**TINY)
    _assert_same_tree(variables, jax_variables)


def test_port_checkpoint_loads_in_jax(tmp_path, jax_variables):
    cfg = ModelConfig(**TINY)
    sd = ckpt.variables_to_state_dict(cfg, jax_variables)
    path = ckpt.save_checkpoint(str(tmp_path / "ck"), cfg,
                                ckpt.state_dict_to_variables(cfg, sd),
                                meta={"epoch": 0})
    jcfg, variables = jax_ckpt.load_checkpoint(path)
    # the JAX loader keeps inception_blocks as the json list
    assert (dataclasses.replace(jcfg, inception_blocks=tuple(
        jcfg.inception_blocks)) == JaxModelConfig(**TINY))
    _assert_same_tree(variables, jax_variables)
    # the file itself is what flax writes for the same tree
    with open(f"{path}/variables.msgpack", "rb") as f:
        assert f.read() == flax.serialization.to_bytes(jax_variables)


def test_state_dict_layouts(jax_variables):
    cfg = ModelConfig(**TINY)
    sd = ckpt.variables_to_state_dict(cfg, jax_variables)
    p, s = jax_variables["params"], jax_variables["batch_stats"]
    conv = p["signal_model"]["conv_layer1"]["Conv_0"]["kernel"]  # [K,Cin,Cout]
    np.testing.assert_array_equal(sd["signal_model.conv_layer1.weight"],
                                  np.asarray(conv).transpose(2, 1, 0))
    np.testing.assert_array_equal(sd["joint_model.fc1.weight"],
                                  np.asarray(p["joint_model"]["fc1"]["kernel"]).T)
    np.testing.assert_array_equal(sd["event_model.bw_0.kernel"],
                                  p["event_model"]["bw_0"]["kernel"])
    bn = s["signal_model"]["incp_layer2"]["branch5_conv1e"]["BatchNorm_0"]
    np.testing.assert_array_equal(
        sd["signal_model.incp_layer2.branch5_conv1e.bn.var"], bn["var"])
    model = DeepSignalNet(cfg)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    back = ckpt.state_dict_to_variables(cfg, model.state_dict())
    _assert_same_tree(back, jax_variables)


def test_state_dict_rejects_mismatch(jax_variables):
    with pytest.raises(ValueError, match="shape"):
        ckpt.variables_to_state_dict(
            ModelConfig(**{**TINY, "lstm_hidden": 16}), jax_variables)


@pytest.mark.parametrize("value", [
    0, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32, 2 ** 64 - 1,
    -1, -32, -33, -128, -129, -32768, -32769, -2 ** 31, -2 ** 31 - 1,
    -2 ** 63, 0.5, -1e300, None, True, False, "", "x" * 31, "x" * 32,
    "y" * 255, "y" * 256, "z" * 70000, "√ü", b"", b"\x00" * 255,
    b"\x01" * 256, b"\x02" * 70000, list(range(15)), list(range(16)),
    list(range(70000)), {"a": 1, "b": [1, "c", None]},
    {str(i): i for i in range(16)}, {str(i): i for i in range(70000)}])
def test_msgpack_plain_values_match_msgpack_package(value):
    encoded = msgpack.packb(value)
    assert encoded == msgpack_pkg.packb(value, use_bin_type=True)
    decoded = msgpack.unpackb(encoded)
    decoded = bytes(decoded) if isinstance(value, bytes) else decoded
    assert decoded == value


@pytest.mark.parametrize("arr", [
    np.arange(6, dtype=np.float32).reshape(2, 3),
    np.zeros((0, 4), np.float32), np.array(3.5, np.float64),
    np.arange(300, dtype=np.int64), np.ones((2, 1, 3), np.uint16),
    np.array([True, False]), np.arange(40000, dtype=np.int8)])
def test_msgpack_arrays_match_flax(arr):
    tree = {"leaf": arr, "nested": {"scalar": np.float32(2.5), "x": arr}}
    encoded = msgpack.serialize_tree(tree)
    assert encoded == flax.serialization.msgpack_serialize(tree)
    back = msgpack.restore_tree(encoded)
    for got, want in ((back["leaf"], arr), (back["nested"]["x"], arr)):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    assert back["nested"]["scalar"] == np.float32(2.5)
    assert isinstance(back["nested"]["scalar"], np.float32)


def test_msgpack_chunked_arrays_match_flax(monkeypatch):
    # shrink the 2**30-byte threshold so a small array is chunked
    monkeypatch.setattr(msgpack, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", 64)
    arr = np.arange(3 * 50, dtype=np.float32).reshape(3, 50)
    tree = {"params": {"big": arr, "small": arr[:1, :4]}}
    encoded = msgpack.serialize_tree(tree)
    assert encoded == flax.serialization.msgpack_serialize(tree)
    back = msgpack.restore_tree(encoded)
    np.testing.assert_array_equal(back["params"]["big"], arr)
    np.testing.assert_array_equal(back["params"]["small"], arr[:1, :4])
    flax_back = flax.serialization.msgpack_restore(encoded)
    np.testing.assert_array_equal(flax_back["params"]["big"], arr)


def test_msgpack_rejects_truncated_data():
    encoded = msgpack.packb({"a": [1, 2, 3]})
    with pytest.raises(ValueError):
        msgpack.unpackb(encoded[:-1])
