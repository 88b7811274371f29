"""Training data pipelines: binary records (memory-mapped) and feature TSV
(port of deepsignal_tpu/train/data.py).

Reference equivalents: ``tf.data.FixedLengthRecordDataset`` + parse_a_line_b
and ``TextLineDataset`` + parse_a_line with a 3*batch shuffle buffer
(train_model.py:67-104, tf_utils.py).  Batches have a fixed shape, the last
one padded by repeating its last row, with its count of real rows under
``"__valid__"``.  Shuffling is a full per-epoch permutation from a
``np.random.Generator``, the same draws as the JAX package's, so one seed
gives the same batches in the same order in both packages.  Feature TSVs
are parsed by the native block parser (``io/native.py``).
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, Optional

import numpy as np

from ..io.feature_codec import (FeatureBatch, binary_record_dtype,
                                feature_widths, iter_feature_bytes_chunks,
                                parse_feature_bytes)


class Batch(dict):
    """A dict batch with a ``valid`` count for the padded tail."""

    @property
    def valid(self) -> int:
        return self["__valid__"]


def _pack(kmers, means, stds, lens, signals, labels, batch_size: int):
    n = kmers.shape[0]
    if n < batch_size:
        pad = batch_size - n

        def p(a):
            return np.concatenate([a, np.repeat(a[-1:], pad, axis=0)])
        kmers, means, stds, lens, signals, labels = map(
            p, (kmers, means, stds, lens, signals, labels))
    b = Batch(kmer=np.ascontiguousarray(kmers, dtype=np.int32),
              means=np.ascontiguousarray(means, dtype=np.float32),
              stds=np.ascontiguousarray(stds, dtype=np.float32),
              sanums=np.ascontiguousarray(lens, dtype=np.float32),
              signals=np.ascontiguousarray(signals, dtype=np.float32),
              labels=np.ascontiguousarray(labels, dtype=np.int32))
    b["__valid__"] = n
    return b


class BinaryFeatureDataset:
    """Memory-mapped fixed-length-record dataset (tf_utils.py:7-28 layout)."""

    def __init__(self, path: str, kmer_len: int = 17, signal_len: int = 360):
        self.path = path
        self.dtype = binary_record_dtype(kmer_len, signal_len)
        self.records = np.memmap(path, dtype=self.dtype, mode="r")

    def __len__(self) -> int:
        return self.records.shape[0]

    def batches(self, batch_size: int,
                shuffle_rng: Optional[np.random.Generator] = None,
                include_partial: bool = True) -> Iterator[Batch]:
        n = len(self)
        order = (shuffle_rng.permutation(n) if shuffle_rng is not None
                 else np.arange(n))
        for i in range(0, n, batch_size):
            idx = np.sort(order[i:i + batch_size])  # sorted -> better mmap IO
            if idx.shape[0] < batch_size and not include_partial:
                return
            rec = self.records[idx]
            yield _pack(rec["bases"], rec["means"], rec["stds"], rec["lens"],
                        rec["signals"], rec["label"].astype(np.int32),
                        batch_size)


class TextFeatureDataset:
    """Streaming TSV dataset with chunked shuffle (TextLineDataset analogue).

    The whole file is never materialized: lines stream in chunks of about
    ``chunk_lines`` rows, each chunk shuffled (a superset of the reference's
    3*batch shuffle buffer, train_model.py:82); the rows that do not fill a
    batch carry over into the next chunk."""

    def __init__(self, path: str, chunk_lines: int = 200_000):
        self.path = path
        self.chunk_lines = chunk_lines

    def batches(self, batch_size: int,
                shuffle_rng: Optional[np.random.Generator] = None,
                include_partial: bool = True) -> Iterator[Batch]:
        carry: Optional[FeatureBatch] = None
        for fb in self._chunks():
            if carry is not None:
                fb = FeatureBatch.concat([carry, fb])
                carry = None
            n = len(fb)
            order = (shuffle_rng.permutation(n) if shuffle_rng is not None
                     else np.arange(n))
            full = (n // batch_size) * batch_size
            for i in range(0, full, batch_size):
                idx = order[i:i + batch_size]
                yield _pack(fb.kmers[idx], fb.means[idx], fb.stds[idx],
                            fb.lens[idx], fb.signals[idx], fb.labels[idx],
                            batch_size)
            if full < n:
                carry = _take(fb, order[full:])
        if carry is not None and include_partial:
            yield _pack(carry.kmers, carry.means, carry.stds, carry.lens,
                        carry.signals, carry.labels, batch_size)

    def _chunks(self) -> Iterator[FeatureBatch]:
        with open(self.path, "rb") as rf:
            first = rf.readline()
        if not first:
            return
        # the widths of the first row hold for the file, as in the JAX
        # package
        kmer_len, signal_len = feature_widths(first)
        chunk_bytes = max(1 << 20, self.chunk_lines * len(first))
        for block in iter_feature_bytes_chunks(self.path, chunk_bytes):
            yield parse_feature_bytes(block, kmer_len, signal_len)


def _take(fb: FeatureBatch, idx: np.ndarray) -> FeatureBatch:
    return FeatureBatch(
        sampleinfo=[fb.sampleinfo[i] for i in idx],
        kmers=fb.kmers[idx], means=fb.means[idx], stds=fb.stds[idx],
        lens=fb.lens[idx], signals=fb.signals[idx], labels=fb.labels[idx])


def prefetch_batches(batches: Iterable, depth: int = 2) -> Iterator:
    """Run a batch iterator in a background thread, ``depth`` items ahead.

    Batch assembly (and, with ``Trainer.stage_batch`` mapped over the
    batches, the host-to-device copy) overlaps the consumer's step.  An
    exception in the producer is re-raised at the consumer's next pull.
    When the consumer stops early (an exception in its loop, or an abandoned
    iterator), the producer is told to stop, is never left blocked on a full
    queue, and is joined: no thread outlives the iterator, and no staged
    batch stays pinned."""
    q: queue.Queue = queue.Queue(maxsize=max(1, depth))
    stop = threading.Event()

    def put(kind, payload) -> bool:
        while not stop.is_set():
            try:
                q.put((kind, payload), timeout=0.05)
                return True
            except queue.Full:
                pass
        return False

    def produce():
        try:
            for b in batches:
                if not put("item", b):
                    return
            put("end", None)
        except BaseException as e:  # propagate, incl. KeyboardInterrupt
            put("error", e)

    t = threading.Thread(target=produce, daemon=True, name="batch-prefetch")
    t.start()
    try:
        while True:
            kind, payload = q.get()
            if kind == "end":
                return
            if kind == "error":
                raise payload
            yield payload
    finally:
        stop.set()
        t.join()


def open_dataset(path: str, is_binary: bool, kmer_len: int = 17,
                 signal_len: int = 360):
    if is_binary:
        return BinaryFeatureDataset(path, kmer_len, signal_len)
    return TextFeatureDataset(path)
