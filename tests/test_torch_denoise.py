"""The port's denoise (``train/denoise.py``, ``tools/dataset.py``) against the
JAX package's: the dataset tools write the same files for one seed, the
sample cleaning keeps the same lines, the driver writes the same final file
when both train through one deterministic stand-in, and the real train
step scores every validation line at a tiny width on the CPU."""

import hashlib
import os
import random

import numpy as np
import pytest
import torch

from deepsignal_tpu.core.config import DenoiseConfig as JaxDenoiseConfig
from deepsignal_tpu.core.config import ModelConfig as JaxModelConfig
from deepsignal_tpu.tools import dataset as jax_dataset
from deepsignal_tpu.train import denoise as jax_denoise
from deepsignal_tpu_torch.cli.main import main as cli_main
from deepsignal_tpu_torch.core.config import DenoiseConfig, ModelConfig
from deepsignal_tpu_torch.tools import dataset
from deepsignal_tpu_torch.train import denoise

torch.set_num_threads(1)

K, S = 5, 24
# tests/test_denoise.py's tiny model
TINY = dict(lstm_hidden=8, lstm_layers=1, inception_times=1,
            inception_blocks=(1, 1, 1), cent_signals_len=S, kmer_len=K,
            is_cnn=False, is_base=False)


def _rows(rng, n, noisy_frac=0.3, k=K, s=S):
    """tests/test_denoise.py's rows: positives are half separable, a
    ``noisy_frac`` of them mislabelled (their signal drawn as negatives)."""
    bases = np.array(list("ACGT"))
    rows = []
    for i in range(n):
        label = int(rng.integers(0, 2))
        true_signal = label
        if label == 1 and rng.random() < noisy_frac:
            true_signal = 0
        shift = 1.5 if true_signal else -1.5
        kmer = "".join(bases[rng.integers(0, 4, k)])
        rows.append("\t".join(
            ["chr1", str(i), "+", str(i), f"r{i}", "t", kmer,
             ",".join(str(x) for x in np.around(rng.normal(shift, 0.3, k),
                                                6)),
             ",".join(str(x) for x in np.around(
                 np.abs(rng.normal(0, 0.3, k)), 6)),
             ",".join(str(x) for x in rng.integers(1, 30, k)),
             ",".join(str(x) for x in np.around(rng.normal(shift, 0.3, s),
                                                6)),
             str(label)]))
    return rows


def _write(path, rows):
    path.write_text("\n".join(rows) + "\n")
    return str(path)


def test_dataset_tools_write_the_jax_files(tmp_path):
    rows = _rows(np.random.default_rng(1), 200)
    src = _write(tmp_path / "all.tsv", rows)
    assert dataset.count_line_num(src) == jax_dataset.count_line_num(src)

    out = {}
    for name, mod in (("port", dataset), ("jax", jax_dataset)):
        a, b = tmp_path / f"{name}.a.tsv", tmp_path / f"{name}.b.tsv"
        lidxs = mod.random_select_file_rows_s(src, str(a), str(b), 77, False,
                                              rng=random.Random(5))
        pos, neg = tmp_path / f"{name}.pos.tsv", tmp_path / f"{name}.neg.tsv"
        pos.write_text("".join(r + "\n" for r in rows[:60]
                               if r.endswith("1")))
        neg.write_text("".join(r + "\n" for r in rows if r.endswith("0")))
        sel = tmp_path / f"{name}.sel.tsv"
        n_sel = mod.select_negsamples_asposkmer(str(pos), str(neg), str(sel),
                                                rng=random.Random(6))
        cat = tmp_path / f"{name}.cat.tsv"
        if mod is dataset:
            mod.concat_two_files(str(pos), str(sel), str(cat),
                                 shuffle_lines_num=7,
                                 rng=np.random.default_rng(8))
        else:
            mod.concat_two_files(str(pos), str(sel), str(cat),
                                 shuffle_lines_num=7, seed=8)
        out[name] = (lidxs, n_sel, a.read_bytes(), b.read_bytes(),
                     sel.read_bytes(), cat.read_bytes())
    assert out["port"] == out["jax"]
    lidxs = out["port"][0]
    assert len(lidxs[0]) == 77 and len(lidxs[0]) + len(lidxs[1]) == 200


def test_clean_samples_matches_jax(tmp_path):
    # tests/test_denoise.py's case
    rows = ["a\tb\t1", "c\td\t1", "e\tf\t0", "g\th\t1"]
    f = _write(tmp_path / "t.tsv", rows)
    idx2probs = {0: [0.9, 0.8], 1: [0.2], 2: [0.9], 3: [0.7]}
    clean_pos, ratio = denoise.clean_samples(f, idx2probs, score_cf=0.5)
    kept = open(clean_pos).read()
    assert kept.splitlines() == ["a\tb\t1", "g\th\t1"]
    assert abs(ratio - 2 / 3) < 1e-9
    jax_pos, jax_ratio = jax_denoise.clean_samples(f, idx2probs, score_cf=0.5)
    assert (clean_pos, ratio) == (jax_pos, jax_ratio)
    assert open(jax_pos).read() == kept


def _stub_train_1time(train_file, valid_file, valid_lidxs, model_cfg, dcfg,
                      *_, seed=0, **__):
    """A deterministic stand-in for train_1time: prob_1 from a hash of the
    validation line, the seed and the training half's size."""
    n_train = sum(1 for _ in open(train_file))
    probs = {}
    with open(valid_file) as f:
        for idx, line in zip(valid_lidxs, f):
            h = hashlib.sha256(f"{seed}:{n_train}:{line}".encode()).digest()
            probs[idx] = h[0] / 255.0
    return probs


def test_denoise_with_a_shared_stub_writes_the_jax_file(tmp_path,
                                                        monkeypatch):
    seed = 11
    rows = _rows(np.random.default_rng(2), 160)
    ours = _write(tmp_path / "ours.tsv", rows)
    theirs = _write(tmp_path / "theirs.tsv", rows)
    kw = dict(iterations=2, epoch_num=1, rounds=2, batch_size=16,
              score_cf=0.4)
    monkeypatch.setattr(denoise, "train_1time", _stub_train_1time)
    monkeypatch.setattr(jax_denoise, "train_1time", _stub_train_1time)
    out = denoise.denoise(ours, ModelConfig(**TINY), DenoiseConfig(**kw),
                          seed=seed, device="cpu")
    # the JAX package draws from the module random and from an unseeded
    # numpy generator: seed the first, and hand it the port's generator
    shared = np.random.default_rng(seed)
    unseeded = np.random.default_rng
    monkeypatch.setattr(np.random, "default_rng",
                        lambda s=None: shared if s is None else unseeded(s))
    random.seed(seed)
    jax_out = jax_denoise.denoise(theirs, JaxModelConfig(**TINY),
                                  JaxDenoiseConfig(**kw), seed=seed)
    monkeypatch.undo()
    assert os.path.basename(out) == "ours.denoise2.tsv"
    assert os.path.basename(jax_out) == "theirs.denoise2.tsv"
    assert open(out, "rb").read() == open(jax_out, "rb").read()
    labels = [int(line.rsplit("\t", 1)[1]) for line in open(out)]
    assert 0 < sum(labels) < len(labels)
    assert sorted(os.listdir(tmp_path)) == [
        "ours.denoise2.tsv", "ours.tsv", "theirs.denoise2.tsv", "theirs.tsv"]


def test_train_1time_scores_every_valid_line_on_the_cpu(tmp_path):
    rng = np.random.default_rng(3)
    train = _write(tmp_path / "train.tsv", _rows(rng, 48))
    valid = _write(tmp_path / "valid.tsv", _rows(rng, 21))
    lidxs = list(range(5, 5 + 2 * 21, 2))
    dcfg = DenoiseConfig(epoch_num=2, batch_size=16, step_interval=1)
    probs = denoise.train_1time(train, valid, lidxs, ModelConfig(**TINY),
                                dcfg, seed=4, device="cpu")
    assert sorted(probs) == lidxs
    assert all(0.0 <= p <= 1.0 for p in probs.values())


def test_denoise_end_to_end_on_the_cpu(tmp_path):
    """tests/test_denoise.py's end-to-end case, through the port."""
    train_f = _write(tmp_path / "train.tsv",
                     _rows(np.random.default_rng(1234), 120))
    dcfg = DenoiseConfig(iterations=1, epoch_num=1, rounds=1, batch_size=16,
                         step_interval=2)
    out = denoise.denoise(train_f, ModelConfig(**TINY), dcfg, seed=7,
                          device="cpu")
    assert out.endswith(".denoise1.tsv") and os.path.exists(out)
    labels = [int(line.rsplit("\t", 1)[1]) for line in open(out)]
    assert 0 < sum(labels) < len(labels)
    assert [p for p in os.listdir(tmp_path)
            if "half" in p or "neg_all" in p] == []


def test_denoise_raises_without_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    train_f = _write(tmp_path / "train.tsv",
                     _rows(np.random.default_rng(5), 4))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        denoise.denoise(train_f, ModelConfig(**TINY))
    assert sorted(os.listdir(tmp_path)) == ["train.tsv"]


def test_cli_denoise_maps_the_jax_flags(tmp_path, monkeypatch):
    seen = {}

    def fake_denoise(train_file, mcfg, dcfg, device=None, mesh=None):
        seen.update(train_file=train_file, mcfg=mcfg, dcfg=dcfg,
                    device=device, mesh=mesh)
        return train_file

    monkeypatch.setattr(denoise, "denoise", fake_denoise)
    assert cli_main(["denoise", "--train_file", "t.tsv", "--seq_len", "13",
                     "--layer_num", "2", "--rounds", "2", "--lr", "0.01",
                     "--keep_prob", "0.7", "--device", "cpu"]) == 0
    mcfg, dcfg = seen["mcfg"], seen["dcfg"]
    assert seen["device"] == "cpu" and seen["train_file"] == "t.tsv"
    # without torchrun's environment no process group and no mesh
    assert seen["mesh"] is None
    # --layer_num is parsed and not passed on, as in the JAX package
    assert (mcfg.kmer_len, mcfg.lstm_layers, mcfg.is_cnn, mcfg.is_base,
            mcfg.is_rnn) == (13, 3, False, False, True)
    assert (dcfg.rounds, dcfg.learning_rate, dcfg.keep_prob,
            dcfg.iterations) == (2, 0.01, 0.7, 6)
