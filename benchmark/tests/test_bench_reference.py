"""The plain reference against the port on the same seeded weights, at a
tiny width on the CPU: the forward (call_mods' probabilities through
ModCaller) and three train steps (Trainer) with dropout."""

import numpy as np
import pytest
import torch

from dsbench import spec, traffic, weights

TINY = {"kmer_len": 5, "cent_signals_len": 40, "class_num": 2,
        "vocab_size": 16, "embedding_size": 8, "lstm_hidden": 16,
        "lstm_layers": 3, "inception_times": 2, "inception_blocks": [1, 1, 1],
        "is_cnn": True, "is_rnn": True, "is_base": True}
PARAMS = {"reads": {"median": 4, "sigma": 1.0, "max": 40},
          "signals_per_base": 9}
B = 16


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, n, cfg):
    d = traffic.rows(seed, n, cfg, PARAMS)
    return d, {"kmer": torch.from_numpy(d["kmer"]),
               "means": torch.from_numpy(d["means"]),
               "stds": torch.from_numpy(d["stds"]),
               "sanums": torch.from_numpy(d["lens"].astype(np.float32)),
               "signals": torch.from_numpy(d["signals"])}


def _program_cfg(cfg, dtype):
    from deepsignal_tpu_torch.core.config import ModelConfig
    return ModelConfig.from_dict({**cfg, "compute_dtype": dtype})


@pytest.mark.parametrize("is_cnn", [True, False])
def test_reference_forward_matches_the_port(is_cnn):
    from deepsignal_tpu_torch.io.feature_codec import FeatureBatch
    from deepsignal_tpu_torch.runtime.caller import ModCaller
    from deepsignal_tpu_torch.train.checkpoints import \
        state_dict_to_variables

    ref = spec.load("references", "deepsignal")
    cfg = dict(TINY, is_cnn=is_cnn, is_base=is_cnn)
    d, x = _inputs(3, B, cfg)
    params = weights.make(ref, cfg, 5, "cpu", x)
    mcfg = _program_cfg(cfg, "float32")
    caller = ModCaller(mcfg, state_dict_to_variables(mcfg, params),
                       batch_size=B, device="cpu")
    fb = FeatureBatch(d["sampleinfo"], d["kmer"], d["means"], d["stds"],
                      d["lens"], d["signals"], d["labels"])
    rows, pred, (p0, p1) = caller.call_feature_batch(fb)
    with torch.no_grad():
        want = ref.call_probs(ref.forward(params, cfg, **x))
    assert np.abs(p1 - want).max() < 1e-6
    assert 0.05 < want.min() and want.max() < 0.95  # calls are not saturated


@pytest.mark.parametrize("is_cnn", [True, False])
def test_reference_train_steps_match_the_port(is_cnn):
    from deepsignal_tpu_torch.core.config import TrainConfig
    from deepsignal_tpu_torch.train.checkpoints import \
        state_dict_to_variables
    from deepsignal_tpu_torch.train.trainer import Trainer

    train = spec.load("drivers", "train")
    ref = spec.load("references", "deepsignal")
    cfg = dict(TINY, is_cnn=is_cnn, is_base=is_cnn)
    d, _ = _inputs(4, 3 * B, cfg)
    pool = train._batches(d, B, 3)
    params = weights.make(ref, cfg, 6, "cpu", train._tensors(pool[0], "cpu"))
    mcfg = _program_cfg(cfg, "float32")
    trainer = Trainer(mcfg, TrainConfig(batch_size=B, keep_prob=0.5),
                      device="cpu")
    gen = torch.Generator().manual_seed(77)
    trainer.restore(state_dict_to_variables(mcfg, params),
                    {"opt_state": {}, "rng": gen.get_state().numpy()})
    named = dict(trainer.model.named_parameters())
    losses = []
    for step, batch in enumerate(pool):
        losses.append(trainer.train_on_batch(batch, 1e-3)[0])
        if step == 0:
            grads = train.first_gradients(trainer.optimizer, named)
    change = {k: float((p.detach() - params[k]).double().norm())
              for k, p in named.items()}
    want = ref.train_steps(params, cfg, [train._tensors(b, "cpu", True)
                                         for b in pool], 0.5, 1e-3, 77)
    state = {"losses": losses, "grad_norms": grads, "change_norms": change}
    gaps = train.gaps(state, want)
    assert gaps["loss_gap"] < 1e-5 and gaps["grad_gap"] < 1e-5
    assert gaps["change_gap"] < 1e-3
