"""Modification-calling engine (port of deepsignal_tpu/runtime/caller.py).

One model on one device (under a process group, one per rank, each on
its shard of the input: ``run_call_mods``).  Feature batches are cut into fixed
``batch_size`` device batches (the last one padded by repeating its last
row), shipped in a compact wire format through pinned host memory with
non-blocking copies, and scored; the sigmoid and argmax run on the device,
the float32 renormalization on the host (call_modifications.py:185-187).
Up to ``pipeline_depth`` feature batches are in flight while the host
formats and writes the previous one.

Each stage is a span (``core/logging.py``), once per device batch:
``caller.read_wait`` (each pull from the input), ``caller.rechunk`` (the
copies that cut the input into device batches), ``caller.dispatch``
holding ``caller.wire`` (wire arrays, pinning, the copies' enqueue) and
``caller.forward`` (the model's launches, sigmoid, argmax, the fetch's
enqueue), ``caller.wait`` (the wait on the device), ``caller.format``
(renormalization and the formatter) and ``caller.write``; ``caller.build``
is the model's set-up.  A span is a ``record_function`` range under any
torch profiler (``run_call_mods`` writes a trace when given
``profile_dir``), an NVTX range under ``emit_nvtx``, and otherwise only an
entry of the in-memory record.
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
from ..core.logging import ThroughputMeter, span, trace
from ..io.calls_codec import (count_read_runs, format_call_block,
                              format_call_rows)
from ..io.feature_codec import FeatureBatch
from ..models.deepsignal import model_from_state_dict, predictions
from ..parallel.dist import rank_and_world, shard_output_path
from ..parallel.mesh import pad_to_multiple
from ..train.checkpoints import load_checkpoint, variables_to_state_dict
from .pipeline import (stream_fast5_feature_batches,
                       stream_file_feature_batches)

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


class ModCaller:
    """The model on its device plus fixed-shape batching.

    ``dispatch_feature_batch`` enqueues the copies and the forward passes
    of a feature batch and returns at once; ``collect_block`` waits for
    them and formats the call rows as one block, ``collect`` as a list of
    rows.  ``call_feature_batch`` does both for one batch."""

    def __init__(self, cfg: ModelConfig, variables, batch_size: int = 4096,
                 device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.batch_size = batch_size
        with span("caller.build"):
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
        with span("caller.wire"):
            kmer, means, stds, counts, signals = (
                self._to_device(a) for a in
                compact_wire_arrays(kmer, means, stds, sanums, signals))
        with span("caller.forward"):
            sanums = counts.to(torch.int32) & 0xFFFF
            logits = self.model(kmer, means, stds, sanums, signals)
            # sigmoid, not softmax (model.py:99-100); argmax at pos_weight 1
            act = self._to_host(torch.sigmoid(logits))
            pred = self._to_host(predictions(logits))
            done = None
            if self._cuda:
                done = torch.cuda.Event()
                done.record(torch.cuda.current_stream(self.device))
        return act, pred, done

    def dispatch_feature_batch(self, fb: FeatureBatch):
        """Enqueue every fixed-shape device batch of ``fb``; returns a
        handle for ``collect`` or ``collect_block``, which may each take it
        more than once."""
        n = len(fb)
        bs = self.batch_size
        pending = []
        with span("caller.dispatch"):
            for i in range(0, n, bs):
                j = min(i + bs, n)
                out = self._run_fixed(*(pad_to_multiple(a[i:j], bs)[0]
                                        for a in (fb.kmers, fb.means, fb.stds,
                                                  fb.lens, fb.signals)))
                pending.append((i, j, out))
        return fb, pending

    @staticmethod
    def _wait(handle) -> None:
        """Wait for every device batch of a dispatch handle."""
        for *_, (_, _, done) in handle[1]:
            with span("caller.wait"):
                if done is not None:
                    done.synchronize()

    @staticmethod
    def _renormalize(handle):
        """(fb, pred int64, p0 f32, p1 f32) of a handle waited on, with the
        reference's host-side float32 renormalization."""
        fb, pending = handle
        n = len(fb)
        all_pred = np.empty(n, dtype=np.int64)
        all_p0 = np.empty(n, dtype=np.float32)
        all_p1 = np.empty(n, dtype=np.float32)
        for i, j, (act, pred, _) in pending:
            act = act.numpy()[:j - i]  # float32 [valid, 2] sigmoid
            total = act[:, 0] + act[:, 1]
            all_p0[i:j] = act[:, 0] / total
            all_p1[i:j] = act[:, 1] / total
            all_pred[i:j] = pred.numpy()[:j - i]
        return fb, all_pred, all_p0, all_p1

    def call_feature_batch(self, fb: FeatureBatch, is_dna: bool = True):
        """Score a FeatureBatch; returns (rows, pred int64 [n], (p0 f32 [n],
        p1 f32 [n])), the rows in input order as ``collect`` gives them."""
        return self.collect(self.dispatch_feature_batch(fb), is_dna=is_dna)

    def collect(self, handle, is_dna: bool = True):
        """Wait on a dispatch handle; returns (rows, pred, (p0, p1)), each
        row a ``str`` without its newline, formatted one site at a time
        (``format_call_rows``): ``collect_block``'s block split into
        lines."""
        self._wait(handle)
        with span("caller.format"):
            fb, all_pred, all_p0, all_p1 = self._renormalize(handle)
            rows = format_call_rows(fb.sampleinfo, all_p0, all_p1, all_pred,
                                    fb.kmers, is_dna)
        return rows, all_pred, (all_p0, all_p1)

    def collect_block(self, handle, is_dna: bool = True):
        """Wait on a dispatch handle; returns (rows as one bytes block,
        pred, (p0, p1)).  The path of ``call_mods``: one native formatter
        call for the whole block."""
        self._wait(handle)
        with span("caller.format"):
            fb, all_pred, all_p0, all_p1 = self._renormalize(handle)
            block = format_call_block(fb.sampleinfo, all_p0, all_p1,
                                      all_pred, fb.kmers, is_dna)
        return block, all_pred, (all_p0, all_p1)


def coalesce_feature_batches(batches: Iterable[FeatureBatch],
                             n: int) -> Iterator[FeatureBatch]:
    """Re-chunk a stream of FeatureBatches into batches of exactly ``n``
    rows (the last one may be smaller), preserving row order.  Each pull
    from ``batches`` is a ``caller.read_wait`` span: the wait on the
    input, without the re-chunking's copies; the concatenation and slices
    that make each batch are a ``caller.rechunk`` span."""
    pending: list = []
    count = 0
    batches = iter(batches)
    while True:
        with span("caller.read_wait"):
            fb = next(batches, None)
        if fb is None:
            break
        pending.append(fb)
        count += len(fb)
        while count >= n:
            with span("caller.rechunk"):
                cat = FeatureBatch.concat(pending) if len(pending) > 1 \
                    else pending[0]
                out, rest = cat[:n], cat[n:]
                pending = [rest] if len(rest) else []
                count = len(rest)
            yield out
    if count:
        with span("caller.rechunk"):
            out = FeatureBatch.concat(pending) if len(pending) > 1 \
                else pending[0]
        yield out


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
            with span("caller.write"):
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
                  compute_dtype=None, device=None, nproc: int = 2,
                  reference_path=None, position_file=None,
                  is_recursive: bool = True, profile_dir=None) -> int:
    """call_mods (call_modifications.py:417-495): score every site of
    ``input_path`` with the checkpoint at ``model_path`` and write the
    10-column call TSV.  Returns the call count.

    ``input_path`` is a feature TSV, parsed in a background reader process,
    or a directory of tombo-resquiggled fast5 files, featurized by ``nproc - 1`` extract workers (at least one) in batches
    of ``f5_batch_num`` files, with ``feature_cfg``, the contig lengths of
    ``reference_path`` and the sites of ``position_file``.  Either starts
    first, so that its start runs beside the checkpoint load.

    ``device=None`` runs on ``cuda`` and raises without a GPU; pass
    ``device="cpu"`` for the CPU.  ``compute_dtype=None`` selects
    ``DEFAULT_COMPUTE_DTYPE`` (bfloat16); pass "float32" for the
    reference-parity path.  With ``profile_dir`` the calling loop runs
    under ``core/logging.py::trace``, which writes a Chrome trace there.

    Under a process group (``parallel/dist.py``) rank k of n calls its
    stride shard of the input, the k-th of the sorted fast5 list or of the
    read-grouped batches of the TSV, on its own device, and writes
    ``<result_file>.part<k>-of-<n>``.  No collective runs: the ranks finish
    on their own, and ``merge_call_shards`` joins their files."""
    start = time.time()
    device = resolve_device(device)
    feature_cfg = feature_cfg or FeatureConfig()
    input_path = os.path.abspath(input_path)
    host_shard = rank_and_world()
    result_file = shard_output_path(result_file, *host_shard)
    if os.path.isdir(input_path):
        batches = stream_fast5_feature_batches(
            input_path, feature_cfg, reference_path=reference_path,
            nproc=nproc, f5_batch_num=f5_batch_num,
            position_file=position_file, is_recursive=is_recursive,
            host_shard=host_shard)
    else:
        batches = stream_file_feature_batches(input_path, f5_batch_num,
                                              background=True,
                                              host_shard=host_shard)
    try:
        cfg, variables = load_checkpoint(os.path.abspath(model_path),
                                         cfg=model_cfg_override)
        cfg = dataclasses.replace(
            cfg, compute_dtype=compute_dtype or DEFAULT_COMPUTE_DTYPE)
        print("compute dtype: %s%s" % (
            cfg.compute_dtype,
            "" if cfg.compute_dtype == "float32"
            else "  (pass --compute_dtype float32 for reference-parity probs)"))
        caller = ModCaller(cfg, variables, batch_size=batch_size,
                           device=device)
        meter = ThroughputMeter("call_mods")
        with trace(profile_dir, device):
            count = call_mods_on_batches(caller, batches, result_file,
                                         meter=meter,
                                         is_dna=feature_cfg.is_dna)
    finally:
        batches.close()
    print(meter.line())
    print("call_mods costs %.2f seconds.." % (time.time() - start))
    return count
