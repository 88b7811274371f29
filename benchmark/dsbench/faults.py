"""Faults planted underneath a run's timed path, each of which the run's
comparison has to catch (``correct`` false): the tests on the CPU and the
readings of the limits on the card plant them through ``run.measure``'s
``fault`` hook."""

from __future__ import annotations


def altered_answer(caller) -> None:
    """The first row of every device batch gets the opposite call, sure of
    itself, where the model produces its logits."""
    forward = caller.model.forward

    def altered(*args, **kwargs):
        logits = forward(*args, **kwargs).clone()
        sign = 1.0 if float(logits[0, 1]) < float(logits[0, 0]) else -1.0
        logits[0, 0], logits[0, 1] = -20.0 * sign, 20.0 * sign
        return logits
    caller.model.forward = altered


def unchanged_state(trainer) -> None:
    """Every optimizer step returns the parameters unchanged."""
    trainer.optimizer.step = lambda *args, **kwargs: None


def half_batch(trainer) -> None:
    """Each step's second half of the batch is left out of the loss: the
    mean is taken over the rest."""
    stage = trainer.stage_batch

    def halved(batch):
        staged = stage(batch)
        n = staged.mask.shape[0]
        mask = staged.mask.clone()
        mask[n // 2:] = 0
        return type(staged)(staged.tensors, mask, n // 2)
    trainer.stage_batch = halved


FAULTS = {"call": {"altered_answer": altered_answer},
          "train": {"unchanged_state": unchanged_state,
                    "half_batch": half_batch}}
