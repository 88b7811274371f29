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
host queues step i + 1 before it waits for step i.

Spans (``core/logging.py``): a step is ``trainer.step`` holding
``trainer.zero_grad``, ``model.forward``, ``trainer.loss``,
``trainer.backward``, ``trainer.optimizer`` and ``trainer.metrics``;
``trainer.stage`` and ``trainer.resolve`` are a batch's copy in and a
step's metrics out; ``trainer.build``, ``trainer.build_optimizer`` and
``trainer.restore`` are the set-up's stages.

On a mesh of ranks (``parallel/mesh.py``; one process per GPU) every rank
sees the same global batch and trains on its contiguous block of it; a
step computes what one process computes on the whole batch, as the JAX
trainer's global mesh does:

- the weights start alike on every rank (the same seed); with a model axis
  each rank keeps its rows of fc1 (``DeepSignalNet.set_mesh``);
- the loss is the global masked mean: each rank's sum over its rows over
  the global batch's valid count (known on every rank), and the gradients
  are summed over the data group in one all-reduce, which gives the
  single-process gradient;
- loss and counts are summed and predictions and probabilities gathered
  over the data group, so every step method returns the global batch's
  values on every rank;
- an axis of one rank issues no collective: a mesh of one rank trains
  as one process does;
- ``train()`` writes logs, checkpoints and the train state from rank 0
  only (every rank takes the same decisions from the same metrics); a
  saved state dict holds the whole fc1, so both packages load it.
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
from ..core.logging import span
from ..models.deepsignal import (DeepSignalNet, predictions,
                                 weighted_ce_with_logits)
from ..parallel.dist import barrier, rank_and_world
from ..parallel.mesh import (TP_PARAM, all_gather_cat, all_reduce_sum_,
                             gather_rows, local_block, mesh_is_multiprocess,
                             shard_rows)
from .checkpoints import (ckpt_name, clean_model_dir, clear_train_state,
                          load_train_state, save_checkpoint, save_train_state,
                          state_dict_to_variables, variables_to_state_dict)
from .data import open_dataset, prefetch_batches
from .metrics import counts_to_metrics, metric_counts

TRAIN_LOG = "train.txt"
VALID_LOG = "valid.txt"
INPUTS = ("kmer", "means", "stds", "sanums", "signals")


def _masked_loss_terms(logits, labels, valid_mask, class_num: int,
                       pos_weight: float):
    """(sum of the masked per-element losses, the masked weights, the
    elements per row) of the reference cost."""
    if pos_weight == 1.0:
        one_hot = F.one_hot(labels.long(), class_num).to(logits.dtype)
        loss = weighted_ce_with_logits(logits, one_hot, pos_weight)
        w = valid_mask[:, None].to(loss.dtype)
        return torch.sum(loss * w), w, class_num
    loss = weighted_ce_with_logits(logits[:, 1], labels.to(logits.dtype),
                                   pos_weight)
    w = valid_mask.to(loss.dtype)
    return torch.sum(loss * w), w, 1


def masked_mean_loss(logits, labels, valid_mask, class_num: int,
                     pos_weight: float, global_valid: Optional[int] = None):
    """Reference cost (model.py:105-118) with padded rows masked out.

    pos_weight == 1: elementwise weighted CE over the one-hot [B, C] grid,
    mean over the valid elements.  Otherwise the scalar class-1-logit form.
    With ``global_valid`` (a data rank's block of a global batch) the sum
    over this block's rows is divided by the global batch's valid count:
    the data ranks' terms sum to the global mean."""
    total, w, per_row = _masked_loss_terms(logits, labels, valid_mask,
                                           class_num, pos_weight)
    if global_valid is not None:
        return total / (global_valid * per_row)
    return total / (torch.sum(w) * per_row)


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
    ``models.deepsignal.init_weights``) and the dropout generator's seed,
    alike on every rank of ``mesh`` (``parallel/mesh.py``; module
    docstring)."""

    def __init__(self, model_cfg: ModelConfig, train_cfg: TrainConfig,
                 device=None, mesh=None):
        self.device = resolve_device(device)
        self.mesh = mesh
        self.mcfg = model_cfg
        self.tcfg = train_cfg
        init_seed, dropout_seed = (int(s) for s in np.random.SeedSequence(
            train_cfg.seed).generate_state(2))
        with span("trainer.build"):
            model = DeepSignalNet(model_cfg, seed=init_seed)
        self.model = model.to(self.device)
        if mesh is not None:
            self.model.set_mesh(mesh)
        self._tp_index = ([n for n, _ in self.model.named_parameters()]
                          .index(TP_PARAM)
                          if mesh is not None and mesh.model > 1 else None)
        # the collectives of an axis of one rank would sum a single term:
        # a mesh of one rank trains as one process does
        self._sync = mesh is not None and mesh_is_multiprocess(mesh)
        self._data_sync = mesh is not None and mesh.data > 1
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(dropout_seed)
        with span("trainer.build_optimizer"):
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
            done.record(torch.cuda.current_stream(self.device))
        return out, done

    @staticmethod
    def _wait(fetched):
        out, done = fetched
        if done is not None:
            done.synchronize()
        return [t.numpy() for t in out]

    def stage_batch(self, batch) -> StagedBatch:
        """Start the host-to-device copy of a ``data.Batch`` now (on a
        mesh, of this rank's block of it; ``valid`` stays the global
        batch's).  Mapped over the batches inside ``prefetch_batches``, it
        runs on the prefetch thread, so the copy of batch i + 1 overlaps
        step i."""
        with span("trainer.stage"):
            batch = dict(batch)
            n = batch["labels"].shape[0]
            valid = batch.pop("__valid__", n)
            mask = np.zeros(n, dtype=np.float32)
            mask[:valid] = 1.0
            if self.mesh is not None:
                data, rank = self.mesh.data, self.mesh.data_rank
                batch, mask = local_block(batch, rank, data), \
                    local_block(mask, rank, data)
            return StagedBatch({k: self._to_device(v)
                                for k, v in batch.items()},
                               self._to_device(mask), valid)

    # -- steps --------------------------------------------------------------

    def train_on_batch_async(self, batch, lr: float):
        """Queue one optimizer step; return a handle for
        ``resolve_metrics``.  The step's loss, counts and predictions are
        already on their way to the host when this returns."""
        with span("trainer.step"):
            tensors, mask, valid = (batch if isinstance(batch, StagedBatch)
                                    else self.stage_batch(batch))
            with span("trainer.zero_grad"):
                for group in self.optimizer.param_groups:
                    group["lr"] = lr
                self.optimizer.zero_grad(set_to_none=True)
            logits = self.model(*(tensors[k] for k in INPUTS), train=True,
                                keep_prob=self.tcfg.keep_prob,
                                generator=self.generator)
            with span("trainer.loss"):
                loss = masked_mean_loss(
                    logits, tensors["labels"], mask, self.mcfg.class_num,
                    self.tcfg.pos_weight, valid if self._data_sync else None)
            with span("trainer.backward"):
                loss.backward()
                if self._sync:
                    self._sum_gradients()
            with span("trainer.optimizer"):
                self.optimizer.step()
            with span("trainer.metrics"):
                preds = predictions(logits.detach(), self.tcfg.pos_weight)
                counts = metric_counts(preds, tensors["labels"], mask)
                loss, counts, (preds,) = self._global(loss.detach(), counts,
                                                      preds)
                return self._fetch(loss, counts, preds), valid

    def _sum_gradients(self) -> None:
        """Sum every gradient over the data group, in one all-reduce.  With
        a model axis the replicated gradients are summed over every rank
        and divided by the model size: each model rank computed them from
        the same rows, and their mean keeps the replicas identical where
        the backward is not bitwise deterministic (cuDNN's weight
        gradients, the embedding's index_add); fc1's rows are summed over
        the data group when it has more than one rank."""
        grads = [p.grad for p in self.model.parameters()
                 if p.grad is not None]
        if self._tp_index is None:
            _sum_flat(grads, self.mesh.data_group)
            return
        fc1 = self.model.get_parameter(TP_PARAM).grad
        rest = [g for g in grads if g is not fc1]
        _sum_flat(rest, self.mesh.group)
        for g in rest:
            g.div_(self.mesh.model)
        if self._data_sync:
            all_reduce_sum_(fc1, self.mesh.data_group)

    def _global(self, loss, counts, *rows):
        """The global batch's loss and counts (summed over the data group)
        and per-row results (gathered); unchanged without a data axis of
        more than one rank."""
        if not self._data_sync:
            return loss, counts, rows
        packed = all_reduce_sum_(
            torch.cat([loss.double().reshape(1), counts.double()]),
            self.mesh.data_group)
        stacked = gather_rows(torch.stack([r.double() for r in rows], 1),
                              self.mesh)
        return (packed[0].to(loss.dtype), packed[1:].to(counts.dtype),
                [stacked[:, i].to(r.dtype) for i, r in enumerate(rows)])

    def resolve_metrics(self, handle):
        """(loss, counts, preds[:valid], valid) of a train-step handle."""
        with span("trainer.resolve"):
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
                                    self.mcfg.class_num, self.tcfg.pos_weight,
                                    valid if self._data_sync else None)
            probs1 = torch.sigmoid(logits[:, 1])
            preds = predictions(logits, self.tcfg.pos_weight)
            counts = metric_counts(preds, tensors["labels"], mask)
            loss, counts, (preds, probs1) = self._global(loss, counts, preds,
                                                         probs1)
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
        """Params and batch-norm statistics in flax's layout, fc1 whole.
        With a model axis it gathers fc1: every rank must read it."""
        sd = self.model.state_dict()
        if self._tp_index is not None:
            sd[TP_PARAM] = all_gather_cat(sd[TP_PARAM], self.mesh.model_group)
        return state_dict_to_variables(self.mcfg, sd)

    def train_state(self) -> dict:
        """Adam's state (per parameter index, as ``optimizer.state_dict``
        numbers them; fc1's moments whole) and the dropout generator's
        state, as numpy.  With a model axis every rank must call it."""
        opt = self.optimizer.state_dict()["state"]
        out = {}
        for i, st in opt.items():
            if i == self._tp_index:  # the moments; the step is a scalar
                st = {k: all_gather_cat(v, self.mesh.model_group)
                      if v.dim() else v for k, v in st.items()}
            out[str(i)] = {k: v.detach().cpu().numpy() for k, v in st.items()}
        return {"opt_state": out, "rng": self.generator.get_state().numpy()}

    def restore(self, variables, train_state) -> None:
        """Restore params, batch-norm statistics, Adam and the generator
        (on a mesh with a model axis, this rank's rows of fc1)."""
        with span("trainer.restore"):
            sd = {k: torch.from_numpy(v) for k, v in
                  variables_to_state_dict(self.mcfg, variables).items()}
            if self._tp_index is not None:
                sd[TP_PARAM] = shard_rows(sd[TP_PARAM], self.mesh)
            self.model.load_state_dict(sd)
            opt = self.optimizer.state_dict()
            opt["state"] = {}
            for i, st in train_state["opt_state"].items():
                st = {k: torch.from_numpy(np.array(v)) for k, v in st.items()}
                if int(i) == self._tp_index:
                    st = {k: shard_rows(v, self.mesh) if v.dim() else v
                          for k, v in st.items()}
                opt["state"][int(i)] = st
            self.optimizer.load_state_dict(opt)
            self.generator.set_state(torch.from_numpy(
                np.array(train_state["rng"])))

    def epoch_lr(self, epoch_id: int) -> float:
        """Single-step LR decay (train_model.py:123-126)."""
        if epoch_id in (0, 1):
            return self.tcfg.learning_rate
        return self.tcfg.learning_rate * self.tcfg.decay_rate


def _sum_flat(tensors: list, group) -> None:
    """Sum ``tensors`` in place over ``group`` through one flat buffer."""
    flat = all_reduce_sum_(torch.cat([t.reshape(-1) for t in tensors]),
                           group)
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()


def _log_line(epoch_id, iid, loss, acc, rec, prec) -> str:
    return ("epoch:%d, iterid:%d, loss:%.3f, accuracy:%.3f, recall:%.3f, "
            "precision:%.3f\n" % (epoch_id, iid, loss, acc, rec, prec))


def train(train_file: str, valid_file: str, model_dir: str,
          log_dir: Optional[str], model_cfg: ModelConfig,
          train_cfg: TrainConfig, is_binary: bool = False,
          trainer: Optional[Trainer] = None, resume: bool = False,
          device=None, mesh=None) -> dict:
    """The training loop with the reference's logging and checkpoint
    semantics (module docstring).  ``device=None`` trains on ``cuda``, on a
    mesh ``mesh`` of ranks when given (``parallel/mesh.py``); then every
    rank must call it, and rank 0 alone writes files.

    ``resume=True`` continues from the rolling train-state checkpoint in
    ``model_dir`` (params, Adam, generator, shuffle stream, epoch counters)
    and starts afresh when there is none.  Returns {best_accuracy,
    epochs_run, model_path}."""
    train_start = time.time()
    tcfg = train_cfg
    mcfg = model_cfg
    if trainer is None:
        trainer = Trainer(mcfg, tcfg, device=device, mesh=mesh)
    shuffle_rng = np.random.default_rng(tcfg.seed)
    # every rank reads the same metrics and so takes the same checkpoint
    # and early-stop decisions; only rank 0 touches the files
    is_lead = rank_and_world()[0] == 0

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
    elif is_lead:
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
        variables = trainer.variables  # a collective under tensor parallel
        if is_lead:
            save_checkpoint(path, mcfg, variables, meta=meta)
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
            if log_dir is not None and is_lead:
                with open(os.path.join(log_dir, TRAIN_LOG), "a") as f:
                    f.write(_log_line(epoch_id, iid, np.mean(tr_loss),
                                      np.mean(tr_acc), np.mean(tr_rec),
                                      np.mean(tr_prec)))
            va_loss, va_acc, va_rec, va_prec = _validate(trainer, valid_ds,
                                                         tcfg, mcfg)
            sweeps_run += 1
            if log_dir is not None and is_lead:
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
            variables, state = trainer.variables, trainer.train_state()
            if is_lead:
                save_train_state(
                    model_dir, mcfg, variables, state,
                    meta={"next_epoch": epoch_id + 1,
                          "test_accu_best": test_accu_best,
                          "best_path": best_path, "epochs_run": epochs_run,
                          "shuffle_state": shuffle_rng.bit_generator.state})
        if not improved and epoch_id >= tcfg.min_epoch_num - 1:
            break
    # every rank returns once rank 0's files are written
    if trainer.mesh is not None:
        barrier(trainer.device)

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
