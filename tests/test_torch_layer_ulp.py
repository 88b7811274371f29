"""The port's float32 model against the flax model, layer by layer, on the
tiny call model of ``torch_tiny.py``, and the committed golden call TSV.

Each layer of the port runs on the input the flax model gave that layer
(flax ``capture_intermediates``), so a layer's difference is its own and
not the sum of the layers before it.  Each layer's difference is printed
in two units: the largest elementwise ulp distance, and the largest
absolute difference in ulps of the layer's largest value.  A layer that
rounds ``n`` times on the way to an output (a sum of ``n`` products; batch
norm's rsqrt, subtract, multiply and add; the residual add) may differ by up to about ``n``
of the latter (float32 sums in another order; XLA's own rsqrt and its
fused multiply-add in batch norm); a layer that does not round (relu,
max pooling, concatenation) must not differ at all.

Regenerate the golden files (after an intended change only):

    python tests/test_torch_layer_ulp.py --regen
"""

import os
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_tiny as tt  # noqa: E402

torch.set_num_threads(1)

PROB_TOL = 1e-5  # float32 sums in another order (test_torch_caller.py)
# |p1 - p0| of every golden call is at least this, so that a card whose
# probabilities sit within its own tolerance of these calls gives the same
# labels
LABEL_MARGIN = 1e-3
# batch norm at inference: rsqrt(var + eps), x - mean, * (inv * scale), +
# bias
BN_ROUNDINGS = 4


def _ulps(a, b) -> int:
    """Largest distance in float32 steps between a and b, elementwise."""
    def ordered(x):
        i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return int(np.abs(ordered(a) - ordered(b)).max())


def _scaled(a, b) -> float:
    """max |a - b| in ulps of max |b|."""
    top = np.float32(np.abs(b).max())
    return float(np.abs(np.float64(a) - np.float64(b)).max()
                 / np.spacing(top)) if top else 0.0


def _jax_forward(cfg_kwargs, variables, args):
    import jax

    from deepsignal_tpu.core.config import ModelConfig as JaxModelConfig
    from deepsignal_tpu.models.deepsignal import DeepSignalNet as JaxNet
    jcfg = JaxModelConfig(**cfg_kwargs, compute_dtype="float32",
                          matmul_precision="highest")

    def apply(v, *a):
        return JaxNet(jcfg).apply(v, *a, train=False,
                                  capture_intermediates=True,
                                  mutable=["intermediates"])
    logits, state = jax.jit(apply)(variables, *args)

    def flat(tree, prefix=()):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from flat(v, prefix + (k,))
            else:
                name = ".".join(prefix)
                yield name, np.asarray(v[0] if isinstance(v, tuple) else v)
    return np.asarray(logits), dict(flat(state["intermediates"]))


@pytest.fixture(scope="module")
def captured():
    from deepsignal_tpu_torch.io.feature_codec import parse_feature_lines
    from deepsignal_tpu_torch.models.deepsignal import model_from_state_dict
    from deepsignal_tpu_torch.train.checkpoints import \
        state_dict_to_variables

    cfg, sd = tt.tiny_cfg(), tt.tiny_state_dict()
    fb = parse_feature_lines(tt.tiny_feature_rows())
    args = (fb.kmers, fb.means, fb.stds, fb.lens.astype(np.float32),
            fb.signals)
    logits, jx = _jax_forward(tt.TINY, state_dict_to_variables(cfg, sd),
                              args)
    model = model_from_state_dict(cfg, sd, torch.device("cpu"))
    return model, args, logits, jx


def _layer_cases(model, args, jx):
    """(name, port output, flax output, roundings per output) for every
    layer, each port layer fed the flax input of that layer."""
    from deepsignal_tpu_torch.models.layers import max_pool_same, tf_same_pads
    from deepsignal_tpu_torch.ops.bilstm import lstm_layer

    def j(name):  # a flax [B, L, C] activation in the port's [B, C, L]
        a = jx[name]
        if name.startswith("signal_model") and a.ndim == 3:
            a = a.transpose(0, 2, 1)
        return torch.from_numpy(a.copy())

    def back(t):  # the port's [B, C, L] in flax's [B, L, C]
        return t.numpy().transpose(0, 2, 1)

    cases = []

    def conv_bn_relu(prefix, module, x):
        pads = tf_same_pads(x.shape[-1], module.weight.shape[-1],
                            module.stride)
        conv = F.conv1d(F.pad(x, pads) if any(pads) else x, module.weight,
                        stride=module.stride)
        cin, k = module.weight.shape[1:]
        cases.append((f"{prefix}.Conv_0", back(conv),
                      jx[f"{prefix}.Conv_0"], cin * k))
        bn = module.bn(j(f"{prefix}.Conv_0"))
        cases.append((f"{prefix}.BatchNorm_0", back(bn),
                      jx[f"{prefix}.BatchNorm_0"], BN_ROUNDINGS))
        if module.use_relu:
            relu = F.relu(j(f"{prefix}.BatchNorm_0"))
            cases.append((prefix, back(relu), jx[prefix], 0))

    with torch.inference_mode():
        kmer, means, stds, sanums, signals = (torch.from_numpy(a)
                                              for a in args)
        # the event branch: each layer-direction on the flax input
        enc = model.event_model
        fusion = torch.cat([model.embedding[kmer.long()], means[..., None],
                            stds[..., None], sanums[..., None]], dim=2)
        for i in range(enc.num_layers):
            for side in ("fw", "bw"):
                layer = getattr(enc, f"{side}_{i}")
                x = fusion if i == 0 else j(f"event_model.{side}_{i - 1}")
                out = lstm_layer(x, layer.kernel, layer.bias,
                                 reverse=side == "bw")
                cases.append((f"event_model.{side}_{i}", out.numpy(),
                              jx[f"event_model.{side}_{i}"],
                              layer.kernel.shape[0]))
        cases.append(("event_model", torch.cat(
            [j("event_model.fw_2")[:, -1], j("event_model.bw_2")[:, 0]],
            dim=1).numpy(), jx["event_model"], 0))

        # the signal branch
        net = model.signal_model
        x = signals[:, None, :]
        conv_bn_relu("signal_model.conv_layer1", net.conv_layer1, x)
        conv_bn_relu("signal_model.conv_layer2", net.conv_layer2,
                     max_pool_same(j("signal_model.conv_layer1"), 3, 2))
        conv_bn_relu("signal_model.conv_layer3", net.conv_layer3,
                     j("signal_model.conv_layer2"))
        prev, idx = "signal_model.conv_layer3", 1
        for stage, n_blocks in enumerate(net.blocks):
            for b in range(n_blocks):
                x = j(prev)
                if stage > 0 and b == 0:
                    x = max_pool_same(x, 3, 2)
                p = f"signal_model.incp_layer{idx}"
                block = getattr(net, f"incp_layer{idx}")
                conv_bn_relu(f"{p}.branch1_conv1a", block.branch1_conv1a,
                             max_pool_same(x, 3, 1))
                for name in ("branch2_conv0b", "branch3_conv0c",
                             "branch4_conv0d", "branch5_convstem",
                             "branch5_conv0e"):
                    conv_bn_relu(f"{p}.{name}", getattr(block, name), x)
                for name, src in (("branch3_conv1c", "branch3_conv0c"),
                                  ("branch4_conv1d", "branch4_conv0d"),
                                  ("branch5_conv1e", "branch5_conv0e"),
                                  ("branch5_conv2e", "branch5_conv1e")):
                    conv_bn_relu(f"{p}.{name}", getattr(block, name),
                                 j(f"{p}.{src}"))
                b5 = F.relu(j(f"{p}.branch5_convstem")
                            + j(f"{p}.branch5_conv2e"))
                out = torch.cat([j(f"{p}.branch1_conv1a"),
                                 j(f"{p}.branch2_conv0b"),
                                 j(f"{p}.branch3_conv1c"),
                                 j(f"{p}.branch4_conv1d"), b5], dim=1)
                # the residual add of branch 5
                cases.append((p, back(out), jx[p], 1))
                prev, idx = p, idx + 1
        pooled = F.avg_pool1d(j(prev), 7, 1, padding=3,
                              count_include_pad=False)
        cases.append(("signal_model", pooled.transpose(1, 2).reshape(
            pooled.shape[0], -1).numpy(), jx["signal_model"], 7))

        # the joint head
        joint = torch.cat([j("event_model"), j("signal_model")], dim=1)
        head = model.joint_model
        cases.append(("joint_model.fc1",
                      F.linear(joint, head.fc1.weight).numpy(),
                      jx["joint_model.fc1"], joint.shape[1]))
        cases.append(("joint_model.fc2",
                      F.linear(j("joint_model.fc1"), head.fc2.weight).numpy(),
                      jx["joint_model.fc2"], joint.shape[1]))
    return cases


def test_each_layer_within_the_order_of_its_sums(captured, capsys):
    model, args, _, jx = captured
    cases = _layer_cases(model, args, jx)
    # 6 layer-directions and the encoder's output; 3 stem convs (conv, batch
    # norm, relu); per block 10 convs (8 with a relu) and its output; the
    # average pool; fc1 and fc2
    assert len(cases) == 7 + 3 * 3 + 3 * (10 * 2 + 8 + 1) + 1 + 2
    report, over = [], []
    for name, got, want, roundings in cases:
        assert got.shape == want.shape, name
        ulps, scaled = _ulps(got, want), _scaled(got, want)
        report.append(f"  {name:52s} roundings {roundings:3d}  max ulp "
                      f"{ulps:6d}  max |d| {scaled:4.1f} ulp of the max")
        if scaled > roundings or (roundings == 0 and ulps):
            over.append(name)
    with capsys.disabled():
        print("\nport vs flax, float32, each layer on the flax input:")
        print("\n".join(report))
    assert over == []


def test_logits_differ_only_by_float32_sums(captured):
    model, args, logits, _ = captured
    with torch.inference_mode():
        got = model(*(torch.from_numpy(a) for a in args)).numpy()
    # every layer's own difference above, carried through the model
    np.testing.assert_allclose(got, logits, rtol=0, atol=1e-5)


def _jax_calls(features: str, ckpt: str, out: str) -> None:
    from deepsignal_tpu.core.config import FeatureConfig as JaxFeatureConfig
    from deepsignal_tpu.runtime.caller import run_call_mods
    run_call_mods(features, ckpt, out,
                  JaxFeatureConfig(kmer_len=tt.K, cent_signals_len=tt.S),
                  batch_size=16, f5_batch_num=3, use_mesh=False,
                  compute_dtype="float32")


def _jax_checkpoint(path: str) -> str:
    from deepsignal_tpu.core.config import ModelConfig as JaxModelConfig
    from deepsignal_tpu.train.checkpoints import save_checkpoint
    from deepsignal_tpu_torch.train.checkpoints import \
        state_dict_to_variables
    return save_checkpoint(path, JaxModelConfig(**tt.TINY),
                           state_dict_to_variables(tt.tiny_cfg(),
                                                   tt.tiny_state_dict()))


def test_golden_files_are_the_jax_packages_output(tmp_path):
    with open(tt.FEATURES) as f:
        assert f.read() == "".join(r + "\n" for r in tt.tiny_feature_rows())
    _jax_calls(tt.FEATURES, _jax_checkpoint(str(tmp_path / "m.ckpt")),
               str(tmp_path / "calls.tsv"))
    with open(tt.CALLS_F32, "rb") as f:
        assert (tmp_path / "calls.tsv").read_bytes() == f.read()
    with open(tt.CALLS_F32) as f:
        p = np.float32([line.split("\t")[6:8] for line in f])
    assert np.abs(p[:, 1] - p[:, 0]).min() >= LABEL_MARGIN
    assert 0 < (p[:, 1] > p[:, 0]).sum() < len(p)


def test_port_f32_calls_match_the_golden_calls(tmp_path, capsys):
    from deepsignal_tpu_torch.runtime.caller import run_call_mods
    from deepsignal_tpu_torch.train.checkpoints import (
        save_checkpoint, state_dict_to_variables)
    cfg = tt.tiny_cfg()
    ckpt = save_checkpoint(str(tmp_path / "m.ckpt"), cfg,
                           state_dict_to_variables(cfg, tt.tiny_state_dict()))
    run_call_mods(tt.FEATURES, ckpt, str(tmp_path / "calls.tsv"),
                  batch_size=16, f5_batch_num=3, compute_dtype="float32",
                  device="cpu")
    got = (tmp_path / "calls.tsv").read_text().splitlines()
    with open(tt.CALLS_F32) as f:
        want = f.read().splitlines()
    assert len(got) == len(want) == tt.N_ROWS
    for g, w in zip(got, want):
        g, w = g.split("\t"), w.split("\t")
        assert g[:6] + g[8:] == w[:6] + w[8:]
        np.testing.assert_allclose(np.float32(g[6:8]), np.float32(w[6:8]),
                                   rtol=0, atol=PROB_TOL)
    with capsys.disabled():
        print(f"\nport (CPU) vs the golden JAX calls, float32: "
              f"{sum(g == w for g, w in zip(got, want))}/{tt.N_ROWS} "
              f"lines byte-identical")


if __name__ == "__main__":
    if "--regen" in sys.argv:
        import tempfile

        import jax
        jax.config.update("jax_platforms", "cpu")
        sys.path.insert(0, os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        with open(tt.FEATURES, "w") as f:
            f.write("".join(r + "\n" for r in tt.tiny_feature_rows()))
        with tempfile.TemporaryDirectory() as td:
            _jax_calls(tt.FEATURES, _jax_checkpoint(os.path.join(td, "m")),
                       tt.CALLS_F32)
        print(f"wrote {tt.FEATURES} and {tt.CALLS_F32}")
