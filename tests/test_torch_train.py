"""The port's training slice against deepsignal_tpu on the CPU: one train
step against ``jax.value_and_grad`` of the flax model, the datasets' batches
for one seed, ``train()`` end to end with a checkpoint the JAX package
loads, exact resume, dropout, the initializers, and the host helpers the
trainer copies (losses, predictions, metrics, checkpoint directories)."""

import os
import re
import threading

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deepsignal_tpu.core.config import ModelConfig as JaxModelConfig
from deepsignal_tpu.io.feature_codec import \
    convert_txt_to_binary as jax_convert_txt_to_binary
from deepsignal_tpu.io.feature_codec import \
    read_binary_features as jax_read_binary_features
from deepsignal_tpu.models.deepsignal import DeepSignalNet as JaxNet
from deepsignal_tpu.models.deepsignal import init_model
from deepsignal_tpu.models.deepsignal import predictions as jax_predictions
from deepsignal_tpu.models.deepsignal import \
    weighted_ce_with_logits as jax_weighted_ce
from deepsignal_tpu.train import checkpoints as jax_ckpt
from deepsignal_tpu.train import data as jax_data
from deepsignal_tpu.train import metrics as jax_metrics
from deepsignal_tpu.train.trainer import masked_mean_loss as jax_masked_loss
from deepsignal_tpu.train.trainer import metric_counts as jax_metric_counts
from deepsignal_tpu_torch.cli.main import build_parser
from deepsignal_tpu_torch.core.config import ModelConfig, TrainConfig
from deepsignal_tpu_torch.io.feature_codec import (binary_record_len,
                                                   convert_txt_to_binary,
                                                   read_binary_features)
from deepsignal_tpu_torch.models import layers
from deepsignal_tpu_torch.models.deepsignal import (TRUNCATED_STD,
                                                    DeepSignalNet,
                                                    model_from_state_dict,
                                                    predictions,
                                                    weighted_ce_with_logits)
from deepsignal_tpu_torch.train import checkpoints, data, metrics
from deepsignal_tpu_torch.train.checkpoints import variables_to_state_dict
from deepsignal_tpu_torch.train.trainer import (INPUTS, Trainer,
                                                masked_mean_loss, train)

torch.set_num_threads(1)

K, S = 5, 24
TINY = dict(lstm_hidden=8, lstm_layers=1, inception_times=1,
            inception_blocks=(1, 1, 1), cent_signals_len=S, kmer_len=K)
# hidden 128 x 3 layers: at batch >= 8 without live dropout the port takes
# the fused encoder and its autograd Function
FUSED = dict(TINY, lstm_hidden=128, lstm_layers=3)
# float32 on one CPU, both sides: the same sums in another order
TOL = 1e-5
LOG_LINE = re.compile(r"epoch:\d+, iterid:\d+, loss:\d+\.\d{3}, "
                      r"accuracy:\d\.\d{3}, recall:\d\.\d{3}, "
                      r"precision:\d\.\d{3}$")


def _fea_rows(rng, n, separable=True):
    """Feature TSV rows; the label shifts the means and signals."""
    rows = []
    bases = np.array(list("ACGT"))
    for i in range(n):
        label = int(rng.integers(0, 2))
        shift = (1.0 if label else -1.0) if separable else 0.0
        kmer = "".join(bases[rng.integers(0, 4, K)])
        means = np.around(rng.normal(shift, 0.3, K), 6)
        stds = np.around(np.abs(rng.normal(0, 0.3, K)), 6)
        lens = rng.integers(1, 30, K)
        cent = np.around(rng.normal(shift, 0.3, S), 6)
        rows.append("\t".join(
            ["chr1", str(i), "+", str(i), f"read{i // 5}", "t", kmer,
             ",".join(map(str, means)), ",".join(map(str, stds)),
             ",".join(str(int(x)) for x in lens),
             ",".join(map(str, cent)), str(label)]))
    return rows


def _write(path, rows):
    path.write_text("\n".join(rows) + "\n")
    return str(path)


def _batch(rng, b, valid):
    batch = dict(kmer=rng.integers(0, 4, (b, K)).astype(np.int32),
                 means=rng.normal(0, 1, (b, K)).astype(np.float32),
                 stds=np.abs(rng.normal(0, 1, (b, K))).astype(np.float32),
                 sanums=rng.integers(1, 30, (b, K)).astype(np.float32),
                 signals=rng.normal(0, 1, (b, S)).astype(np.float32),
                 labels=rng.integers(0, 2, b).astype(np.int32))
    batch["__valid__"] = valid
    return batch


def _port_trainer(widths, variables, **train_kw):
    cfg = ModelConfig(**widths)
    trainer = Trainer(cfg, TrainConfig(batch_size=16, **train_kw),
                      device="cpu")
    trainer.model.load_state_dict({
        k: torch.from_numpy(v)
        for k, v in variables_to_state_dict(cfg, variables).items()})
    return cfg, trainer


# ---------------------------------------------------------------------------
# (c) one train step against the flax model


@pytest.mark.parametrize("widths,pos_weight", [(TINY, 1.0), (TINY, 2.0),
                                               (FUSED, 1.0)],
                         ids=["per_layer", "pos_weight", "fused"])
def test_train_step_matches_jax(widths, pos_weight):
    rng = np.random.default_rng(0)
    model, variables = init_model(JaxModelConfig(**widths),
                                  jax.random.PRNGKey(3))
    batch = _batch(rng, 16, valid=13)
    mask = (np.arange(16) < 13).astype(np.float32)
    lr = 1e-3

    def loss_fn(params):
        logits, new = model.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            *(jnp.asarray(batch[k]) for k in INPUTS), train=True,
            keep_prob=1.0, mutable=["batch_stats"])
        return jax_masked_loss(logits, jnp.asarray(batch["labels"]),
                               jnp.asarray(mask), 2, pos_weight), \
            new["batch_stats"]

    (loss, new_stats), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(variables["params"])
    tx = optax.adam(lr)
    updates, _ = tx.update(grads, tx.init(variables["params"]),
                           variables["params"])
    stepped = optax.apply_updates(variables["params"], updates)

    cfg, trainer = _port_trainer(widths, variables, keep_prob=1.0,
                                 pos_weight=pos_weight)
    got_loss, _counts, preds, valid = trainer.train_on_batch(dict(batch), lr)
    assert valid == 13 and preds.shape == (13,)
    np.testing.assert_allclose(got_loss, float(loss), rtol=0, atol=TOL)

    def as_torch(params, stats):
        return variables_to_state_dict(cfg, jax.device_get(
            {"params": params, "batch_stats": stats}))

    want_grads = as_torch(grads, variables["batch_stats"])
    for name, p in trainer.model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_grads[name], rtol=0,
                                   atol=TOL, err_msg=f"grad {name}")
    want = as_torch(stepped, new_stats)
    got = trainer.model.state_dict()
    for name in want:
        if name.endswith((".mean", ".var")):
            np.testing.assert_allclose(got[name].numpy(), want[name], rtol=0,
                                       atol=TOL, err_msg=f"stat {name}")
    # Adam's first step moves a parameter by lr * g / (|g| + 1e-8): about
    # lr * sign(g) for |g| >> 1e-8, but anywhere in [-lr, lr] where |g| is
    # near 1e-8, so a gradient that differs at rounding level can move such
    # a parameter by up to 2 lr.  Where |g| > 1e-4 the step's sensitivity
    # lr * 1e-8 / g**2 is at most lr, so the params agree to rounding.
    for name, p in trainer.model.named_parameters():
        g = np.abs(want_grads[name])
        diff = np.abs(p.detach().numpy() - want[name])
        assert diff[g > 1e-4].max(initial=0) <= 1e-6, name
        assert diff.max() <= 2 * lr * (1 + 1e-6), name


# ---------------------------------------------------------------------------
# losses, predictions and metrics the trainer copies


@pytest.mark.parametrize("pos_weight", [1.0, 2.5])
def test_losses_and_predictions_match_jax(pos_weight):
    rng = np.random.default_rng(1)
    logits = rng.normal(0, 3, (32, 2)).astype(np.float32)
    logits[:4, 1] = logits[:4, 0]  # ties
    labels = rng.integers(0, 2, 32).astype(np.int32)
    mask = (np.arange(32) < 27).astype(np.float32)
    z = rng.uniform(0, 1, (32, 2)).astype(np.float32)
    np.testing.assert_allclose(
        weighted_ce_with_logits(torch.from_numpy(logits), torch.from_numpy(z),
                                pos_weight).numpy(),
        np.asarray(jax_weighted_ce(jnp.asarray(logits), jnp.asarray(z),
                                   pos_weight)), rtol=0, atol=TOL)
    np.testing.assert_allclose(
        float(masked_mean_loss(torch.from_numpy(logits),
                               torch.from_numpy(labels),
                               torch.from_numpy(mask), 2, pos_weight)),
        float(jax_masked_loss(jnp.asarray(logits), jnp.asarray(labels),
                              jnp.asarray(mask), 2, pos_weight)),
        rtol=0, atol=TOL)
    preds = predictions(torch.from_numpy(logits), pos_weight)
    np.testing.assert_array_equal(
        preds.numpy(),
        np.asarray(jax_predictions(jnp.asarray(logits), pos_weight)))
    np.testing.assert_array_equal(
        metrics.metric_counts(preds, torch.from_numpy(labels),
                              torch.from_numpy(mask)).numpy(),
        np.asarray(jax_metric_counts(jnp.asarray(preds.numpy()),
                                     jnp.asarray(labels), jnp.asarray(mask))))


@pytest.mark.parametrize("counts", [[10, 7, 3, 1, 2], [5, 5, 0, 0, 0],
                                    [0, 0, 0, 0, 0]])
@pytest.mark.parametrize("class_num", [2, 3])
def test_counts_to_metrics_match_jax(counts, class_num):
    assert metrics.counts_to_metrics(np.array(counts), class_num) == \
        jax_metrics.counts_to_metrics(np.array(counts), class_num)


# ---------------------------------------------------------------------------
# (d) datasets


@pytest.mark.parametrize("seed", [None, 5])
def test_text_dataset_yields_the_jax_batches(tmp_path, seed):
    # 4,000 rows of ~300 bytes span two of the 1 MB chunks, so the rows that
    # do not fill a batch carry over into the next chunk
    rows = _fea_rows(np.random.default_rng(2), 4000)
    path = _write(tmp_path / "t.tsv", rows)
    assert os.path.getsize(path) > 1 << 20

    def batches(mod):
        rng = None if seed is None else np.random.default_rng(seed)
        return list(mod.TextFeatureDataset(path, chunk_lines=10).batches(
            64, shuffle_rng=rng))

    want, got = batches(jax_data), batches(data)
    assert len(got) == len(want) == 63
    for g, w in zip(got, want):
        assert g.keys() == w.keys() and g.valid == w.valid
        for k in INPUTS + ("labels",):
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k])


def test_binary_file_and_dataset_match_jax(tmp_path):
    rows = _fea_rows(np.random.default_rng(3), 45)
    txt = _write(tmp_path / "t.tsv", rows)
    ours, theirs = str(tmp_path / "ours.bin"), str(tmp_path / "theirs.bin")
    assert convert_txt_to_binary(txt, ours, K, S, chunk_lines=16) == 45
    jax_convert_txt_to_binary(txt, theirs, K, S)
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    assert os.path.getsize(ours) == 45 * binary_record_len(K, S)
    got, want = read_binary_features(ours, K, S), \
        jax_read_binary_features(ours, K, S)
    for field in ("kmers", "means", "stds", "lens", "signals", "labels"):
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field))
    for seed in (None, 9):
        def batches(mod):
            rng = None if seed is None else np.random.default_rng(seed)
            return list(mod.BinaryFeatureDataset(ours, K, S).batches(
                16, shuffle_rng=rng))
        want, got = batches(jax_data), batches(data)
        assert [g.valid for g in got] == [w.valid for w in want] == [16, 16,
                                                                      13]
        for g, w in zip(got, want):
            for k in INPUTS + ("labels",):
                np.testing.assert_array_equal(g[k], w[k])


def test_prefetch_stops_its_producer_when_the_consumer_stops():
    """A consumer that stops early must not leave the producer thread
    blocked on a full queue."""
    produced = []

    def items():
        for i in range(1000):
            produced.append(i)
            yield i

    it = data.prefetch_batches(items(), depth=2)
    assert next(it) == 0
    it.close()
    assert not any(t.name == "batch-prefetch" and t.is_alive()
                   for t in threading.enumerate())
    assert len(produced) < 10
    assert list(data.prefetch_batches(iter(range(50)), depth=3)) == \
        list(range(50))

    def boom():
        yield 1
        raise RuntimeError("producer failed")

    with pytest.raises(RuntimeError, match="producer failed"):
        list(data.prefetch_batches(boom()))


# ---------------------------------------------------------------------------
# (e) dropout


def test_dropout_keeps_about_keep_prob_and_scales_the_rest():
    x = torch.full((200_000,), 3.0)
    for keep_prob in (0.5, 0.8):
        y = layers.dropout(x, keep_prob, torch.Generator().manual_seed(0))
        kept = y != 0
        assert abs(kept.float().mean().item() - keep_prob) < 0.005
        assert torch.all(y[kept] == torch.tensor(3.0) / keep_prob)
    same = [layers.dropout(x, 0.5, torch.Generator().manual_seed(1))
            for _ in range(2)]
    assert torch.equal(*same)
    assert layers.dropout(x, 1.0, None) is x


def test_one_generator_seed_gives_one_loss():
    rng = np.random.default_rng(4)
    batch = _batch(rng, 16, valid=16)

    def loss(seed):
        trainer = Trainer(ModelConfig(**TINY),
                          TrainConfig(batch_size=16, seed=seed), device="cpu")
        return trainer.train_on_batch(dict(batch), 1e-3)[0]

    assert loss(7) == loss(7)
    assert loss(7) != loss(8)


def test_joint_head_drops_after_the_logits():
    model = DeepSignalNet(ModelConfig(**TINY))
    batch = _batch(np.random.default_rng(5), 64, valid=64)
    logits = model(*(torch.from_numpy(batch[k]) for k in INPUTS), train=True,
                   keep_prob=0.5, generator=torch.Generator().manual_seed(0))
    zeros = (logits == 0).float().mean().item()
    assert 0.3 < zeros < 0.7
    with torch.no_grad():
        assert (model(*(torch.from_numpy(batch[k]) for k in INPUTS)) != 0).all()


@pytest.mark.parametrize("train_mode,keep_prob,batch,fused", [
    (True, 0.5, 16, False),   # live dropout: the per-layer path
    (True, 1.0, 16, True),    # no dropout, a shape K1 takes
    (False, 0.5, 16, True),   # eval
    (False, 1.0, 4, False),   # batch below 8: the per-layer path
])
def test_encoder_path_follows_the_jax_rule(monkeypatch, train_mode, keep_prob,
                                           batch, fused):
    calls = {"scan": 0, "fused": 0}

    def counting(name, fn):
        def wrapped(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)
        return wrapped

    monkeypatch.setattr(layers, "lstm_layer_scan",
                        counting("scan", layers.lstm_layer_scan))
    monkeypatch.setattr(layers, "bilstm_encoder_fused",
                        counting("fused", layers.bilstm_encoder_fused))
    enc = layers.BiLSTMEncoder(7, hidden=128, num_layers=3)
    for p in enc.parameters():
        torch.nn.init.normal_(p, std=0.05)
    out = enc(torch.randn(batch, 5, 7), train_mode, keep_prob,
              torch.Generator().manual_seed(0))
    assert out.shape == (batch, 256)
    assert calls == ({"scan": 0, "fused": 1} if fused
                     else {"scan": 6, "fused": 0})


# ---------------------------------------------------------------------------
# (f) train() end to end, (g) resume


def test_train_end_to_end_checkpoint_loads_in_jax(tmp_path):
    rng = np.random.default_rng(6)
    train_f = _write(tmp_path / "train.tsv", _fea_rows(rng, 120))
    valid_f = _write(tmp_path / "valid.tsv", _fea_rows(rng, 40))
    cfg = ModelConfig(**TINY)
    log_dir = str(tmp_path / "logs")
    summary = train(train_f, valid_f, str(tmp_path / "model"), log_dir, cfg,
                    TrainConfig(batch_size=16, learning_rate=0.005,
                                max_epoch_num=2, min_epoch_num=1,
                                display_step=4), device="cpu")
    assert summary["epochs_run"] >= 1
    assert summary["best_accuracy"] > 0.6
    assert os.path.basename(summary["model_path"]).startswith(
        f"bn_{K}.sn_{S}.epoch_")
    for name in ("train.txt", "valid.txt"):
        lines = open(os.path.join(log_dir, name)).read().splitlines()
        assert lines[0].startswith("epoch:0, iterid:4, loss:")
        assert all(LOG_LINE.match(line) for line in lines), lines

    jax_cfg, jax_vars = jax_ckpt.load_checkpoint(summary["model_path"])
    batch = _batch(np.random.default_rng(7), 16, valid=16)
    want = JaxNet(jax_cfg).apply(
        jax_vars, *(jnp.asarray(batch[k]) for k in INPUTS), train=False)
    model = model_from_state_dict(cfg, variables_to_state_dict(cfg, jax_vars),
                                  "cpu")
    with torch.no_grad():
        got = model(*(torch.from_numpy(batch[k]) for k in INPUTS))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=TOL)


def test_resume_matches_unbroken_run(tmp_path):
    """Stopping after epoch 0 and resuming reproduces an unbroken 3-epoch
    run bit for bit (Adam, generator and shuffle stream restored)."""
    rng = np.random.default_rng(8)
    train_f = _write(tmp_path / "train.tsv", _fea_rows(rng, 64))
    valid_f = _write(tmp_path / "valid.tsv", _fea_rows(rng, 16))
    cfg = ModelConfig(**TINY)

    def tcfg(max_epochs):
        return TrainConfig(batch_size=16, learning_rate=0.005,
                           max_epoch_num=max_epochs, min_epoch_num=3,
                           display_step=2, seed=7)

    dir_a, dir_b = str(tmp_path / "unbroken"), str(tmp_path / "resumed")
    sum_a = train(train_f, valid_f, dir_a, None, cfg, tcfg(3), device="cpu")
    train(train_f, valid_f, dir_b, None, cfg, tcfg(1), device="cpu")
    sum_b = train(train_f, valid_f, dir_b, None, cfg, tcfg(3), resume=True,
                  device="cpu")
    assert sum_b["epochs_run"] == sum_a["epochs_run"] == 3
    assert sum_b["best_accuracy"] == sum_a["best_accuracy"]
    for blob in ("variables.msgpack", "train_state.msgpack"):
        a, b = (open(os.path.join(d, "train_state.ckpt", blob), "rb").read()
                for d in (dir_a, dir_b))
        assert a == b, blob


def test_checkpoint_dir_helpers_match_jax(tmp_path):
    for d in ("a", "b"):
        for name in ("bn_5.sn_24.epoch_0.ckpt", "bn_5.sn_24.epoch_3.ckpt",
                     "bn_5.sn_24.epoch_12.ckpt", "bn_9.sn_24.epoch_7.ckpt",
                     "other.txt"):
            (tmp_path / d / name).mkdir(parents=True)
    assert os.path.basename(checkpoints.latest_checkpoint(
        str(tmp_path / "a"), 5, 24)) == os.path.basename(
        jax_ckpt.latest_checkpoint(str(tmp_path / "b"), 5, 24)) == \
        "bn_5.sn_24.epoch_12.ckpt"
    assert checkpoints.clean_model_dir(str(tmp_path / "a"), 5, 24) == \
        jax_ckpt.clean_model_dir(str(tmp_path / "b"), 5, 24) == 3
    assert sorted(os.listdir(tmp_path / "a")) == \
        sorted(os.listdir(tmp_path / "b"))
    assert checkpoints.latest_checkpoint(str(tmp_path / "a"), 5, 24) is None


def test_train_runs_on_cuda_unless_asked_for_the_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train(str(tmp_path / "t.tsv"), str(tmp_path / "v.tsv"),
              str(tmp_path / "m"), None, ModelConfig(**TINY), TrainConfig())
    assert not (tmp_path / "m").exists()


def test_cli_train_flags_and_defaults():
    args = build_parser().parse_args(
        ["train", "--train_file", "t", "--valid_file", "v", "-o", "m"])
    assert args.device == "cuda" and args.keep_prob == 0.5
    assert (args.batch_size, args.learning_rate, args.max_epoch_num,
            args.min_epoch_num, args.display_step, args.seed) == \
        (512, 0.001, 10, 5, 100, 42)


# ---------------------------------------------------------------------------
# (h) initializers


def test_init_moments_and_bounds_match_init_model():
    widths = dict(TINY, lstm_hidden=32, inception_times=2, kmer_len=9,
                  cent_signals_len=60)
    cfg = ModelConfig(**widths)
    _, variables = init_model(JaxModelConfig(**widths), jax.random.PRNGKey(0))
    theirs = variables_to_state_dict(cfg, variables)
    ours = {k: v.detach().numpy()
            for k, v in DeepSignalNet(cfg, seed=0).state_dict().items()}
    assert ours.keys() == theirs.keys()
    for name, a in ours.items():
        b = theirs[name]
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("bias", "mean"):
            assert not a.any() and not b.any(), name
            continue
        if leaf in ("scale", "var"):
            assert (a == 1).all() and (b == 1).all(), name
            continue
        if leaf == "kernel":  # glorot_uniform over [(D+H), 4H]
            std = (2.0 / (a.shape[0] + a.shape[1])) ** 0.5
            bound = 3 ** 0.5 * std
        elif name == "embedding":  # truncated_normal(sqrt(2 / vocab))
            bound = 2 * (2.0 / a.shape[0]) ** 0.5
            std = bound / 2 * TRUNCATED_STD
        else:  # lecun_normal: truncated at 2 std, variance 1 / fan_in
            std = a[0].size ** -0.5
            bound = 2 * std / TRUNCATED_STD
        for v in (a, b):
            assert np.abs(v).max() <= bound * (1 + 1e-6), name
            if v.size < 200:
                continue
            assert np.abs(v).max() > 0.8 * bound, name
            # sample std of n draws: within 5 standard errors of the law's
            np.testing.assert_allclose(v.std(), std,
                                       rtol=5 / (2 * v.size) ** 0.5,
                                       err_msg=name)
            assert abs(v.mean()) < 5 * std / v.size ** 0.5, name
