"""Modification-calling engine (port of deepsignal_tpu/runtime/caller.py).

One model on one device.  Feature batches are cut into fixed
``batch_size`` device batches (the last one padded by repeating its last
row), shipped in a compact wire format through pinned host memory with
non-blocking copies, and scored; the sigmoid and argmax run on the device,
the float32 renormalization on the host (call_modifications.py:185-187).
Up to ``pipeline_depth`` feature batches are in flight while the host
formats and writes the previous one.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time
from collections import deque
from typing import Iterable, Iterator

import numpy as np
import torch

from ..core.config import FeatureConfig, ModelConfig
from ..core.device import resolve_device
from ..core.logging import ThroughputMeter
from ..io.calls_codec import count_read_runs, format_call_block
from ..io.feature_codec import FeatureBatch, iter_feature_batches_by_read
from ..models.deepsignal import model_from_state_dict, predictions
from ..train.checkpoints import load_checkpoint, variables_to_state_dict

# The shipped call_mods compute dtype, as in the JAX package; pass
# compute_dtype="float32" for the reference-parity path.
DEFAULT_COMPUTE_DTYPE = "bfloat16"
U16_MAX = 65535


def compact_wire_arrays(kmer, means, stds, sanums, signals):
    """The host-to-device wire: int8 k-mer codes, float32 features, and the
    per-base signal counts clipped to the uint16 range of the reference's
    ``<u2`` binary record and shipped as their int16 bit pattern (PyTorch
    has little uint16 support); the device widens them back with
    ``& 0xFFFF``.  Floats stay float32 on the wire and are cast to the
    compute dtype on the device, the same round-to-nearest-even as the JAX
    package's host-side bfloat16 cast."""
    counts = np.clip(sanums, 0, U16_MAX).astype(np.uint16)
    return (np.ascontiguousarray(kmer, dtype=np.int8),
            np.ascontiguousarray(means, dtype=np.float32),
            np.ascontiguousarray(stds, dtype=np.float32),
            np.ascontiguousarray(counts.view(np.int16)),
            np.ascontiguousarray(signals, dtype=np.float32))


def _pad(arr: np.ndarray, batch_size: int) -> np.ndarray:
    """Pad the leading axis to the fixed batch size by repeating the last
    row; the padded lanes are dropped by the valid count."""
    n = arr.shape[0]
    if n == batch_size:
        return arr
    reps = np.repeat(arr[-1:], batch_size - n, axis=0)
    return np.concatenate([arr, reps], axis=0)


class ModCaller:
    """The model on its device plus fixed-shape batching.

    ``dispatch_feature_batch`` enqueues the copies and the forward passes
    of a feature batch and returns at once; ``collect_block`` waits for
    them and formats the call rows."""

    def __init__(self, cfg: ModelConfig, variables, batch_size: int = 4096,
                 device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.batch_size = batch_size
        self.model = model_from_state_dict(
            cfg, variables_to_state_dict(cfg, variables), self.device)
        self._cuda = self.device.type == "cuda"
        self._warned_counts = False

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(arr)
        if self._cuda:
            t = t.pin_memory()
        return t.to(self.device, non_blocking=True)

    def _to_host(self, t: torch.Tensor) -> torch.Tensor:
        out = torch.empty(t.shape, dtype=t.dtype, pin_memory=self._cuda)
        out.copy_(t, non_blocking=True)
        return out

    @torch.inference_mode()
    def _run_fixed(self, kmer, means, stds, sanums, signals):
        if np.max(sanums, initial=0) > U16_MAX and not self._warned_counts:
            self._warned_counts = True
            print("warning: per-base signal count > 65535 clipped to the "
                  "uint16 wire range (the reference's <u2 binary record "
                  "limit)", file=sys.stderr)
        kmer, means, stds, counts, signals = (
            self._to_device(a) for a in
            compact_wire_arrays(kmer, means, stds, sanums, signals))
        sanums = counts.to(torch.int32) & 0xFFFF
        logits = self.model(kmer, means, stds, sanums, signals)
        # sigmoid, not softmax (model.py:99-100); argmax at pos_weight 1
        act = self._to_host(torch.sigmoid(logits))
        pred = self._to_host(predictions(logits))
        done = None
        if self._cuda:
            done = torch.cuda.Event()
            done.record()
        return act, pred, done

    def dispatch_feature_batch(self, fb: FeatureBatch):
        """Enqueue every fixed-shape device batch of ``fb``; returns a
        handle for ``collect_block``."""
        n = len(fb)
        bs = self.batch_size
        pending = []
        for i in range(0, n, bs):
            j = min(i + bs, n)
            out = self._run_fixed(_pad(fb.kmers[i:j], bs),
                                  _pad(fb.means[i:j], bs),
                                  _pad(fb.stds[i:j], bs),
                                  _pad(fb.lens[i:j], bs),
                                  _pad(fb.signals[i:j], bs))
            pending.append((i, j, out))
        return fb, pending

    def _resolve(self, handle):
        """Wait on a dispatch handle; returns (fb, pred int64, p0 f32,
        p1 f32) with the reference's host-side float32 renormalization."""
        fb, pending = handle
        n = len(fb)
        all_pred = np.empty(n, dtype=np.int64)
        all_p0 = np.empty(n, dtype=np.float32)
        all_p1 = np.empty(n, dtype=np.float32)
        for i, j, (act, pred, done) in pending:
            if done is not None:
                done.synchronize()
            act = act.numpy()[:j - i]  # float32 [valid, 2] sigmoid
            total = act[:, 0] + act[:, 1]
            all_p0[i:j] = act[:, 0] / total
            all_p1[i:j] = act[:, 1] / total
            all_pred[i:j] = pred.numpy()[:j - i]
        return fb, all_pred, all_p0, all_p1

    def collect_block(self, handle, is_dna: bool = True):
        """Wait on a dispatch handle; returns (rows as one bytes block,
        pred, (p0, p1))."""
        fb, all_pred, all_p0, all_p1 = self._resolve(handle)
        block = format_call_block(fb.sampleinfo, all_p0, all_p1, all_pred,
                                  fb.kmers, is_dna)
        return block, all_pred, (all_p0, all_p1)


def coalesce_feature_batches(batches: Iterable[FeatureBatch],
                             n: int) -> Iterator[FeatureBatch]:
    """Re-chunk a stream of FeatureBatches into batches of exactly ``n``
    rows (the last one may be smaller), preserving row order."""
    pending: list = []
    count = 0
    for fb in batches:
        pending.append(fb)
        count += len(fb)
        while count >= n:
            cat = FeatureBatch.concat(pending) if len(pending) > 1 \
                else pending[0]
            yield cat[:n]
            rest = cat[n:]
            pending = [rest] if len(rest) else []
            count = len(rest)
    if count:
        yield FeatureBatch.concat(pending) if len(pending) > 1 \
            else pending[0]


def call_mods_on_batches(caller: ModCaller, batches: Iterable[FeatureBatch],
                         out_path: str, meter=None, is_dna: bool = True,
                         pipeline_depth: int = 2) -> int:
    """Stream read-grouped FeatureBatches -> call TSV; returns the row
    count.  Up to ``pipeline_depth`` device batches are dispatched ahead
    of the one being formatted and written."""
    count = 0
    in_flight: deque = deque()
    # a read's rows are contiguous, so the new reads of a batch are its
    # same-read runs, less one when it continues the last batch's read
    prev_last_read = None
    with open(out_path, "wb") as wf:
        def drain_one():
            nonlocal count, prev_last_read
            handle = in_flight.popleft()
            fb = handle[0]
            block, _, _ = caller.collect_block(handle, is_dna=is_dna)
            wf.write(block)
            count += len(fb)
            if meter is not None and fb.sampleinfo:
                runs, first, last = count_read_runs(fb.sampleinfo)
                meter.update(sites=len(fb),
                             reads=runs - (1 if first == prev_last_read
                                           else 0))
                prev_last_read = last

        for fb in coalesce_feature_batches(batches, caller.batch_size):
            in_flight.append(caller.dispatch_feature_batch(fb))
            if len(in_flight) > pipeline_depth:
                drain_one()
        while in_flight:
            drain_one()
    return count


def run_call_mods(input_path: str, model_path: str, result_file: str,
                  feature_cfg=None, batch_size: int = 4096,
                  f5_batch_num: int = 50, model_cfg_override=None,
                  compute_dtype=None, device=None) -> int:
    """call_mods on a feature TSV (call_modifications.py:417-495): score
    every row with the checkpoint at ``model_path`` and write the 10-column
    call TSV.  Returns the call count.

    ``device=None`` runs on ``cuda`` and raises without a GPU; pass
    ``device="cpu"`` for the CPU.  ``compute_dtype=None`` selects
    ``DEFAULT_COMPUTE_DTYPE`` (bfloat16); pass "float32" for the
    reference-parity path."""
    start = time.time()
    device = resolve_device(device)
    if os.path.isdir(input_path):
        raise NotImplementedError(
            "fast5-directory input is not yet ported to deepsignal_tpu_torch;"
            " extract a feature TSV first and pass that")
    feature_cfg = feature_cfg or FeatureConfig()
    cfg, variables = load_checkpoint(os.path.abspath(model_path),
                                     cfg=model_cfg_override)
    cfg = dataclasses.replace(
        cfg, compute_dtype=compute_dtype or DEFAULT_COMPUTE_DTYPE)
    print("compute dtype: %s%s" % (
        cfg.compute_dtype,
        "" if cfg.compute_dtype == "float32"
        else "  (pass --compute_dtype float32 for reference-parity probs)"))
    caller = ModCaller(cfg, variables, batch_size=batch_size, device=device)
    batches = iter_feature_batches_by_read(os.path.abspath(input_path),
                                           f5_batch_num)
    meter = ThroughputMeter("call_mods")
    count = call_mods_on_batches(caller, batches, result_file, meter=meter,
                                 is_dna=feature_cfg.is_dna)
    print(meter.line())
    print("call_mods costs %.2f seconds.." % (time.time() - start))
    return count
