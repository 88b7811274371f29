"""Training loop on one device (port of deepsignal_tpu/train/trainer.py).

Reference semantics (train_model.py:24-285) as the JAX package keeps them:

- one train step = forward with batch-norm batch statistics and dropout at
  ``keep_prob``, the masked weighted cross-entropy, backward, one Adam step
  (optax's defaults: betas 0.9 / 0.999, eps 1e-8, which is
  ``torch.optim.Adam``'s update); batches have a fixed shape and their
  padded tail is masked out of the loss and the metrics;
- LR = lr for epochs 0-1, lr * decay_rate after (train_model.py:123-126);
- every ``display_step`` iterations a full validation sweep and one line in
  each of train.txt / valid.txt, in the reference's parseable format
  (train_model.py:186-189,233-236);
- a checkpoint at every new global-best validation accuracy
  (train_model.py:239-243), one epoch-final sweep when no display-step sweep
  ran in the epoch, and early stop when an epoch does not improve and
  epoch_id >= min_epoch_num - 1 (train_model.py:270-284);
- ``resume`` continues from the rolling train-state checkpoint and
  reproduces an unbroken run.

The step's metrics (loss, counts, predictions) come back through pinned
host buffers with non-blocking copies and are read one step late, so the
host queues step i + 1 before it waits for step i.  The multi-device and
multi-host branches of the JAX trainer are not ported.
"""

from __future__ import annotations

import os
import sys
import time
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..core.config import ModelConfig, TrainConfig
from ..core.device import resolve_device
from ..models.deepsignal import (DeepSignalNet, predictions,
                                 weighted_ce_with_logits)
from .checkpoints import (ckpt_name, clean_model_dir, clear_train_state,
                          load_train_state, save_checkpoint, save_train_state,
                          state_dict_to_variables, variables_to_state_dict)
from .data import open_dataset, prefetch_batches
from .metrics import counts_to_metrics, metric_counts

TRAIN_LOG = "train.txt"
VALID_LOG = "valid.txt"
INPUTS = ("kmer", "means", "stds", "sanums", "signals")


def masked_mean_loss(logits, labels, valid_mask, class_num: int,
                     pos_weight: float):
    """Reference cost (model.py:105-118) with padded rows masked out.

    pos_weight == 1: elementwise weighted CE over the one-hot [B, C] grid,
    mean over the valid elements.  Otherwise the scalar class-1-logit form."""
    if pos_weight == 1.0:
        one_hot = F.one_hot(labels.long(), class_num).to(logits.dtype)
        loss = weighted_ce_with_logits(logits, one_hot, pos_weight)
        w = valid_mask[:, None].to(loss.dtype)
        return torch.sum(loss * w) / (torch.sum(w) * class_num)
    loss = weighted_ce_with_logits(logits[:, 1], labels.to(logits.dtype),
                                   pos_weight)
    w = valid_mask.to(loss.dtype)
    return torch.sum(loss * w) / torch.sum(w)


class StagedBatch(NamedTuple):
    """A batch on the trainer's device: input and label tensors, the [B]
    float mask of real rows, and their count."""

    tensors: dict
    mask: torch.Tensor
    valid: int


class Trainer:
    """The model, its Adam state and its dropout generator on one device,
    and the train and eval steps.

    ``train_cfg.seed`` gives both the initial weights (flax's initializers,
    ``models.deepsignal.init_weights``) and the dropout generator's seed."""

    def __init__(self, model_cfg: ModelConfig, train_cfg: TrainConfig,
                 device=None):
        self.device = resolve_device(device)
        self.mcfg = model_cfg
        self.tcfg = train_cfg
        init_seed, dropout_seed = (int(s) for s in np.random.SeedSequence(
            train_cfg.seed).generate_state(2))
        self.model = DeepSignalNet(model_cfg, seed=init_seed).to(self.device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(dropout_seed)
        self.optimizer = torch.optim.Adam(
            self.model.parameters(), lr=train_cfg.learning_rate,
            betas=(0.9, 0.999), eps=1e-8)
        self._cuda = self.device.type == "cuda"

    # -- host <-> device ----------------------------------------------------

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(arr)
        if self._cuda:
            t = t.pin_memory()
        return t.to(self.device, non_blocking=True)

    def _fetch(self, *tensors):
        """Start non-blocking copies of ``tensors`` into pinned host
        memory; returns a handle for ``_wait``."""
        out = []
        for t in tensors:
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=self._cuda)
            host.copy_(t, non_blocking=True)
            out.append(host)
        done = None
        if self._cuda:
            done = torch.cuda.Event()
            done.record()
        return out, done

    @staticmethod
    def _wait(fetched):
        out, done = fetched
        if done is not None:
            done.synchronize()
        return [t.numpy() for t in out]

    def stage_batch(self, batch) -> StagedBatch:
        """Start the host-to-device copy of a ``data.Batch`` now.  Mapped
        over the batches inside ``prefetch_batches``, it runs on the
        prefetch thread, so the copy of batch i + 1 overlaps step i."""
        batch = dict(batch)
        n = batch["labels"].shape[0]
        valid = batch.pop("__valid__", n)
        mask = np.zeros(n, dtype=np.float32)
        mask[:valid] = 1.0
        return StagedBatch({k: self._to_device(v) for k, v in batch.items()},
                           self._to_device(mask), valid)

    # -- steps --------------------------------------------------------------

    def train_on_batch_async(self, batch, lr: float):
        """Queue one optimizer step; return a handle for
        ``resolve_metrics``.  The step's loss, counts and predictions are
        already on their way to the host when this returns."""
        tensors, mask, valid = (batch if isinstance(batch, StagedBatch)
                                else self.stage_batch(batch))
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.zero_grad(set_to_none=True)
        logits = self.model(*(tensors[k] for k in INPUTS), train=True,
                            keep_prob=self.tcfg.keep_prob,
                            generator=self.generator)
        loss = masked_mean_loss(logits, tensors["labels"], mask,
                                self.mcfg.class_num, self.tcfg.pos_weight)
        loss.backward()
        self.optimizer.step()
        preds = predictions(logits.detach(), self.tcfg.pos_weight)
        counts = metric_counts(preds, tensors["labels"], mask)
        return self._fetch(loss.detach(), counts, preds), valid

    def resolve_metrics(self, handle):
        """(loss, counts, preds[:valid], valid) of a train-step handle."""
        fetched, valid = handle
        loss, counts, preds = self._wait(fetched)
        return float(loss), counts, preds[:valid], valid

    def train_on_batch(self, batch, lr: float):
        return self.resolve_metrics(self.train_on_batch_async(batch, lr))

    def eval_on_batch_async(self, batch):
        """Queue one eval step (running batch-norm statistics, no
        dropout); resolve with ``resolve_eval``."""
        tensors, mask, valid = (batch if isinstance(batch, StagedBatch)
                                else self.stage_batch(batch))
        with torch.no_grad():
            logits = self.model(*(tensors[k] for k in INPUTS), train=False)
            loss = masked_mean_loss(logits, tensors["labels"], mask,
                                    self.mcfg.class_num, self.tcfg.pos_weight)
            probs1 = torch.sigmoid(logits[:, 1])
            preds = predictions(logits, self.tcfg.pos_weight)
            counts = metric_counts(preds, tensors["labels"], mask)
        return self._fetch(loss, counts, preds, probs1), valid

    def resolve_eval(self, handle):
        """(loss, counts, preds[:valid], probs1[:valid], valid)."""
        fetched, valid = handle
        loss, counts, preds, probs1 = self._wait(fetched)
        return float(loss), counts, preds[:valid], probs1[:valid], valid

    def eval_on_batch(self, batch):
        return self.resolve_eval(self.eval_on_batch_async(batch))

    # -- state --------------------------------------------------------------

    @property
    def variables(self) -> dict:
        """Params and batch-norm statistics in flax's layout."""
        return state_dict_to_variables(self.mcfg, self.model.state_dict())

    def train_state(self) -> dict:
        """Adam's state (per parameter index, as ``optimizer.state_dict``
        numbers them) and the dropout generator's state, as numpy."""
        opt = self.optimizer.state_dict()["state"]
        return {"opt_state": {str(i): {k: v.detach().cpu().numpy()
                                       for k, v in st.items()}
                              for i, st in opt.items()},
                "rng": self.generator.get_state().numpy()}

    def restore(self, variables, train_state) -> None:
        """Restore params, batch-norm statistics, Adam and the generator."""
        sd = variables_to_state_dict(self.mcfg, variables)
        self.model.load_state_dict({k: torch.from_numpy(v)
                                    for k, v in sd.items()})
        opt = self.optimizer.state_dict()
        opt["state"] = {int(i): {k: torch.from_numpy(np.array(v))
                                 for k, v in st.items()}
                        for i, st in train_state["opt_state"].items()}
        self.optimizer.load_state_dict(opt)
        self.generator.set_state(torch.from_numpy(
            np.array(train_state["rng"])))

    def epoch_lr(self, epoch_id: int) -> float:
        """Single-step LR decay (train_model.py:123-126)."""
        if epoch_id in (0, 1):
            return self.tcfg.learning_rate
        return self.tcfg.learning_rate * self.tcfg.decay_rate


def _log_line(epoch_id, iid, loss, acc, rec, prec) -> str:
    return ("epoch:%d, iterid:%d, loss:%.3f, accuracy:%.3f, recall:%.3f, "
            "precision:%.3f\n" % (epoch_id, iid, loss, acc, rec, prec))


def train(train_file: str, valid_file: str, model_dir: str,
          log_dir: Optional[str], model_cfg: ModelConfig,
          train_cfg: TrainConfig, is_binary: bool = False,
          trainer: Optional[Trainer] = None, resume: bool = False,
          device=None) -> dict:
    """The training loop with the reference's logging and checkpoint
    semantics (module docstring).  ``device=None`` trains on ``cuda``.

    ``resume=True`` continues from the rolling train-state checkpoint in
    ``model_dir`` (params, Adam, generator, shuffle stream, epoch counters)
    and starts afresh when there is none.  Returns {best_accuracy,
    epochs_run, model_path}."""
    train_start = time.time()
    tcfg = train_cfg
    mcfg = model_cfg
    if trainer is None:
        trainer = Trainer(mcfg, tcfg, device=device)
    shuffle_rng = np.random.default_rng(tcfg.seed)

    start_epoch = 0
    test_accu_best = 0.0
    best_path = None
    epochs_run = 0

    state = load_train_state(model_dir) if resume else None
    if state is not None:
        _cfg, variables, train_state, meta = state
        trainer.restore(variables, train_state)
        start_epoch = int(meta["next_epoch"])
        test_accu_best = float(meta["test_accu_best"])
        best_path = meta.get("best_path")
        epochs_run = int(meta.get("epochs_run", start_epoch))
        shuffle_rng.bit_generator.state = meta["shuffle_state"]
        print(f"resuming training from epoch {start_epoch} "
              f"(best accuracy so far: {test_accu_best:.3f})")
    else:
        removed = clean_model_dir(model_dir, mcfg.kmer_len,
                                  mcfg.cent_signals_len)
        clear_train_state(model_dir)
        if removed:
            print(f"the previous model ({removed} files) in model_directory "
                  "deleted...")
        if log_dir is not None:
            os.makedirs(log_dir, exist_ok=True)
            for name in (TRAIN_LOG, VALID_LOG):
                p = os.path.join(log_dir, name)
                if os.path.exists(p):
                    os.remove(p)

    train_ds = open_dataset(train_file, is_binary, mcfg.kmer_len,
                            mcfg.cent_signals_len)
    valid_ds = open_dataset(valid_file, is_binary, mcfg.kmer_len,
                            mcfg.cent_signals_len)

    def save_best(epoch_id, meta):
        path = os.path.join(model_dir, ckpt_name(
            mcfg.kmer_len, mcfg.cent_signals_len, epoch_id))
        save_checkpoint(path, mcfg, trainer.variables, meta=meta)
        return path

    for epoch_id in range(start_epoch, tcfg.max_epoch_num):
        start = time.time()
        lr = trainer.epoch_lr(epoch_id)
        tr_loss, tr_acc, tr_rec, tr_prec = [], [], [], []
        test_accu_best_ep = 0.0
        sweeps_run = 0
        iter_id = 0
        pending = None  # (iter_id of the queued step, its metrics handle)

        def consume(iid, handle, params_iter):
            # ``params_iter``: how many optimizer steps the model holds now
            # (one more than ``iid`` when read one step late, equal on the
            # epoch's last read); recorded in the checkpoint's meta
            nonlocal tr_loss, tr_acc, tr_rec, tr_prec
            nonlocal test_accu_best_ep, sweeps_run, best_path, start
            loss, counts, _preds, _valid = trainer.resolve_metrics(handle)
            acc, rec, prec = counts_to_metrics(counts, mcfg.class_num)
            tr_loss.append(loss)
            tr_acc.append(acc)
            tr_rec.append(rec)
            tr_prec.append(prec)
            if iid % tcfg.display_step != 0:
                return
            if log_dir is not None:
                with open(os.path.join(log_dir, TRAIN_LOG), "a") as f:
                    f.write(_log_line(epoch_id, iid, np.mean(tr_loss),
                                      np.mean(tr_acc), np.mean(tr_rec),
                                      np.mean(tr_prec)))
            va_loss, va_acc, va_rec, va_prec = _validate(trainer, valid_ds,
                                                         tcfg, mcfg)
            sweeps_run += 1
            if log_dir is not None:
                with open(os.path.join(log_dir, VALID_LOG), "a") as f:
                    f.write(_log_line(epoch_id, iid, va_loss, va_acc, va_rec,
                                      va_prec))
            if va_acc > test_accu_best_ep:
                test_accu_best_ep = va_acc
                if test_accu_best_ep > test_accu_best:
                    best_path = save_best(epoch_id, {
                        "epoch": epoch_id, "iter": iid,
                        "params_iter": params_iter, "valid_accuracy": va_acc})
            end = time.time()
            sys.stdout.write(
                "epoch: %d, iterid: %d\n train_loss: %.3f, valid_loss: "
                "%.3f, train_accuracy: %.3f, valid_accuracy: %.3f, "
                "curr_epoch_best_accuracy: %.3f, time_cost: %.2fs\n"
                % (epoch_id, iid, np.mean(tr_loss), va_loss,
                   np.mean(tr_acc), va_acc, test_accu_best_ep, end - start))
            sys.stdout.flush()
            tr_loss, tr_acc, tr_rec, tr_prec = [], [], [], []
            start = time.time()

        for batch in prefetch_batches(
                map(trainer.stage_batch,
                    train_ds.batches(tcfg.batch_size,
                                     shuffle_rng=shuffle_rng))):
            handle = trainer.train_on_batch_async(batch, lr)
            iter_id += 1
            if pending is not None:
                consume(*pending, params_iter=iter_id)
            pending = (iter_id, handle)
        if pending is not None:
            consume(*pending, params_iter=pending[0])

        # the reference checks for improvement only at display-step sweeps;
        # an epoch with fewer iterations gets one epoch-final sweep so that
        # short datasets still checkpoint and stop early (the JAX package's
        # deliberate deviation, kept)
        if sweeps_run == 0:
            _, test_accu_best_ep, _, _ = _validate(trainer, valid_ds, tcfg,
                                                   mcfg)
            if test_accu_best_ep > test_accu_best:
                best_path = save_best(epoch_id, {
                    "epoch": epoch_id, "valid_accuracy": test_accu_best_ep})
        epochs_run = epoch_id + 1
        improved = test_accu_best_ep > test_accu_best
        if improved:
            test_accu_best = test_accu_best_ep
        sys.stdout.write("================ epoch %d best accuracy: %.3f, "
                         "best accuracy: %.3f\n"
                         % (epoch_id, test_accu_best_ep, test_accu_best))
        sys.stdout.flush()
        if tcfg.save_state:
            save_train_state(
                model_dir, mcfg, trainer.variables, trainer.train_state(),
                meta={"next_epoch": epoch_id + 1,
                      "test_accu_best": test_accu_best,
                      "best_path": best_path, "epochs_run": epochs_run,
                      "shuffle_state": shuffle_rng.bit_generator.state})
        if not improved and epoch_id >= tcfg.min_epoch_num - 1:
            break

    sys.stdout.write("training finished, costs %.1f seconds..\n"
                     % (time.time() - train_start))
    return {"best_accuracy": test_accu_best, "epochs_run": epochs_run,
            "model_path": best_path}


def _validate(trainer: Trainer, valid_ds, tcfg: TrainConfig,
              mcfg: ModelConfig):
    """(loss, accuracy, recall, precision), each the mean over the
    validation batches."""
    losses, accs, recs, precs = [], [], [], []

    def consume(handle):
        loss, counts, _preds, _probs, _valid = trainer.resolve_eval(handle)
        acc, rec, prec = counts_to_metrics(counts, mcfg.class_num)
        losses.append(loss)
        accs.append(acc)
        recs.append(rec)
        precs.append(prec)

    pending = None  # the metrics are read behind the next batch's compute
    for batch in prefetch_batches(
            map(trainer.stage_batch, valid_ds.batches(tcfg.batch_size))):
        handle = trainer.eval_on_batch_async(batch)
        if pending is not None:
            consume(pending)
        pending = handle
    if pending is not None:
        consume(pending)
    if not losses:
        return 0.0, 0.0, 0.0, 0.0
    return (float(np.mean(losses)), float(np.mean(accs)),
            float(np.mean(recs)), float(np.mean(precs)))
