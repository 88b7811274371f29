"""Cross-rank denoising of training samples (port of
deepsignal_tpu/train/denoise.py; reference ``deepsignal/denoise.py:23-345``).

Each iteration splits the training file into random halves ``rounds``
times, trains a fresh model on each half and scores the other, keeps the
positive samples whose mean predicted prob_1 exceeds ``score_cf``, draws
negatives to the kept positives' k-mer distribution and shuffle-concats both
into the next iteration's training file; it stops after ``iterations`` or
once more than 99% of the positives are kept (denoise.py:339-340).

As in the JAX package, the halves are trained from the TSV directly (the
reference converts them to binary records for tf.data), with fixed-shape
batches.  Each half gets a fresh ``Trainer`` seeded as the JAX package
seeds it.  The random split and the negative draw take a
``random.Random(seed)``, the shuffle-concat a ``np.random.default_rng(seed)``:
with the module ``random`` seeded alike and numpy's unseeded generator
replaced by that one, the JAX package draws the same numbers.

On a mesh of ranks (``parallel/mesh.py``) every half trains on the mesh,
and rank 0 alone writes and removes the files, drawing the random numbers
of the split and the negatives; the other ranks take its results by
broadcast.  (The JAX package writes them from every process, which on one
host would write each path from every rank at once.)
"""

from __future__ import annotations

import os
import random
import sys
import time
from typing import Optional

import numpy as np

from ..core.config import DenoiseConfig, ModelConfig, TrainConfig
from ..core.device import resolve_device
from ..parallel.dist import run_on_lead
from ..tools.dataset import (concat_two_files, count_line_num,
                             random_select_file_rows_s,
                             select_negsamples_asposkmer)
from .data import TextFeatureDataset, prefetch_batches
from .trainer import Trainer

# an epoch's mean train accuracy that ends training (denoise.py:119-120)
EARLY_STOP_ACCURACY = 0.95


def train_1time(train_file: str, valid_file: str, valid_lidxs: list,
                model_cfg: ModelConfig, dcfg: DenoiseConfig, seed: int = 0,
                device=None, mesh=None) -> dict:
    """Train a fresh model on ``train_file`` and score ``valid_file``;
    returns {original line index: prob_1} (denoise.py:33-184).  Training
    stops early when an epoch's mean train accuracy reaches 0.95."""
    tcfg = TrainConfig(batch_size=dcfg.batch_size,
                       learning_rate=dcfg.learning_rate,
                       decay_rate=dcfg.decay_rate, keep_prob=dcfg.keep_prob,
                       max_epoch_num=dcfg.epoch_num,
                       pos_weight=dcfg.pos_weight, seed=seed)
    trainer = Trainer(model_cfg, tcfg, device=device, mesh=mesh)
    train_ds = TextFeatureDataset(train_file)
    shuffle_rng = np.random.default_rng(seed)

    for epoch_id in range(dcfg.epoch_num):
        lr = trainer.epoch_lr(epoch_id)
        accus = []
        iter_id = 0
        start = time.time()
        # the metrics are read one step behind the dispatch, as in train()
        pending = None  # (iter_id, labels, handle)

        def consume(iid, labels, handle):
            nonlocal start
            loss, _counts, preds, valid = trainer.resolve_metrics(handle)
            if iid % dcfg.step_interval == 0:
                accu = float(np.mean(np.asarray(labels)[:valid] == preds))
                accus.append(accu)
                print("Epoch [{}/{}], Step {}, Loss: {:.4f}, Accuracy: "
                      "{:.4f}, Time: {:.2f}s".format(
                          epoch_id + 1, dcfg.epoch_num, iid, loss, accu,
                          time.time() - start))
                sys.stdout.flush()
                start = time.time()

        for labels, batch in prefetch_batches(
                map(lambda b: (b["labels"], trainer.stage_batch(b)),
                    train_ds.batches(tcfg.batch_size,
                                     shuffle_rng=shuffle_rng))):
            handle = trainer.train_on_batch_async(batch, lr)
            iter_id += 1
            if pending is not None:
                consume(*pending)
            pending = (iter_id, labels, handle)
        if pending is not None:
            consume(*pending)
        if accus and np.mean(accus) >= EARLY_STOP_ACCURACY:
            break

    # the validation pass: prob_1 per line, in file order, read one batch
    # behind the dispatch
    valid_ds = TextFeatureDataset(valid_file)
    idx2prob: dict = {}
    cnt = 0

    def consume_eval(handle):
        nonlocal cnt
        _loss, _counts, _preds, probs1, valid = trainer.resolve_eval(handle)
        for p in probs1[:valid]:
            idx2prob[valid_lidxs[cnt]] = float(p)
            cnt += 1

    pending = None
    for batch in prefetch_batches(
            map(trainer.stage_batch, valid_ds.batches(dcfg.batch_size))):
        handle = trainer.eval_on_batch_async(batch)
        if pending is not None:
            consume_eval(pending)
        pending = handle
    if pending is not None:
        consume_eval(pending)
    return idx2prob


def train_rounds(train_file: str, iterstr: str, model_cfg: ModelConfig,
                 dcfg: DenoiseConfig, rng: random.Random, seed: int = 0,
                 device=None, mesh=None) -> dict:
    """One denoise iteration of cross-rank rounds (denoise.py:187-220):
    {line index: [prob_1 of each round]}."""
    print("\n##########Train Cross Rank##########")
    total_num = count_line_num(train_file, False)
    half_num = total_num // 2
    fname, fext = os.path.splitext(train_file)
    idx2probs_all: dict = {i: [] for i in range(total_num)}

    for i in range(dcfg.rounds):
        print("##########Train Cross Rank, Iter {}, Round {}##########"
              .format(iterstr, i + 1))
        f1 = fname + ".half1" + fext
        f2 = fname + ".half2" + fext
        lidxs1, lidxs2 = run_on_lead(
            lambda: random_select_file_rows_s(train_file, f1, f2, half_num,
                                              False, rng=rng), device=device)
        probs2 = train_1time(f1, f2, lidxs2, model_cfg, dcfg,
                             seed=seed + 2 * i, device=device, mesh=mesh)
        probs1 = train_1time(f2, f1, lidxs1, model_cfg, dcfg,
                             seed=seed + 2 * i + 1, device=device, mesh=mesh)
        for idx, p in probs2.items():
            idx2probs_all[idx].append(p)
        for idx, p in probs1.items():
            idx2probs_all[idx].append(p)
        run_on_lead(lambda: (os.remove(f1), os.remove(f2)), device=device)
    print("##########Train Cross Rank, finished!##########")
    sys.stdout.flush()
    return idx2probs_all


def clean_samples(train_file: str, idx2probs: dict,
                  score_cf: float = 0.5):
    """Keep the positives with mean prob_1 > score_cf (denoise.py:223-287).
    Returns (clean_pos_file, left_ratio)."""
    print("\n######clean the samples######")
    idx2mean = {idx: (float(np.mean(ps)) if ps else 0.0)
                for idx, ps in idx2probs.items()}
    pos_total = 0
    pos_hc = set()
    with open(train_file, "r") as rf:
        for i, line in enumerate(rf):
            label = int(line.rstrip("\n").rsplit("\t", 1)[1])
            if label == 1:
                pos_total += 1
                if idx2mean.get(i, 0.0) > score_cf:
                    pos_hc.add(i)
    left_ratio = float(len(pos_hc)) / pos_total if pos_total else 0.0
    print("{} ({}) high quality positive samples left, 0 high quality "
          "negative samples left".format(len(pos_hc), left_ratio))

    fname, fext = os.path.splitext(train_file)
    clean_pos = fname + ".pos.cf" + str(score_cf) + fext
    with open(train_file, "r") as rf, open(clean_pos, "w") as wf:
        for i, line in enumerate(rf):
            if i in pos_hc:
                wf.write(line)
    print("######clean the samples, finished!######")
    sys.stdout.flush()
    return clean_pos, left_ratio


def _all_negative_samples(train_file: str) -> str:
    fname, fext = os.path.splitext(train_file)
    neg_file = fname + ".neg_all" + fext
    with open(train_file) as rf, open(neg_file, "w") as wf:
        for line in rf:
            if int(line.rstrip("\n").rsplit("\t", 1)[1]) == 0:
                wf.write(line)
    return neg_file


def denoise(train_file: str, model_cfg: Optional[ModelConfig] = None,
            dcfg: Optional[DenoiseConfig] = None, seed: int = 0,
            device=None, mesh=None) -> str:
    """The denoise driver (denoise.py:305-345); returns the path of the
    final denoised training file.  ``device=None`` trains on ``cuda`` and
    raises without a GPU; pass ``device="cpu"`` for the CPU.  With
    ``mesh`` every rank must call it (module docstring)."""
    total_start = time.time()
    device = resolve_device(device)
    dcfg = dcfg or DenoiseConfig()
    if model_cfg is None:
        model_cfg = ModelConfig(is_cnn=dcfg.is_cnn, is_rnn=dcfg.is_rnn,
                                is_base=dcfg.is_base,
                                pos_weight=dcfg.pos_weight)
    rng = random.Random(seed)
    np_rng = np.random.default_rng(seed)
    ori_train_file = train_file
    train_neg_file = run_on_lead(_all_negative_samples, train_file,
                                 device=device)

    for iter_c in range(dcfg.iterations):
        print("\n###### cross rank to clean samples, Iter: {} ######"
              .format(iter_c + 1))
        idx2probs = train_rounds(train_file, str(iter_c + 1), model_cfg,
                                 dcfg, rng, seed=seed + 100 * iter_c,
                                 device=device, mesh=mesh)
        fname, fext = os.path.splitext(ori_train_file)
        next_file = fname + ".denoise" + str(iter_c + 1) + fext

        def write_next(train_file=train_file):
            """Clean the positives and write the next training file;
            returns the kept share of the positives."""
            clean_pos, left_ratio = clean_samples(train_file, idx2probs,
                                                  dcfg.score_cf)
            if train_file != ori_train_file:
                os.remove(train_file)

            print("\n#####concat denoised file#####")
            pos_num = count_line_num(clean_pos)
            fname, fext = os.path.splitext(train_neg_file)
            seled_neg = fname + ".r" + str(pos_num) + fext
            select_negsamples_asposkmer(clean_pos, train_neg_file, seled_neg,
                                        rng=rng)
            concat_two_files(clean_pos, seled_neg, concated_fp=next_file,
                             rng=np_rng)
            os.remove(seled_neg)
            os.remove(clean_pos)
            print("#####concat denoised file, finished!#####")
            return left_ratio

        left_ratio = run_on_lead(write_next, device=device)
        train_file = next_file

        if left_ratio > 0.99:
            break

    run_on_lead(os.remove, train_neg_file, device=device)
    print("###### denoised file for training: {}".format(train_file))
    print("###### denoise totally costs {:.2f} seconds"
          .format(time.time() - total_start))
    return train_file
