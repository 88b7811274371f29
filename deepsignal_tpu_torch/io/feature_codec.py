"""Feature-TSV codec (port of deepsignal_tpu/io/feature_codec.py).

TSV rows are parsed by the native block parser (``io/native.py``,
``csrc/fastparse.cpp``); ``parse_feature_lines_plain`` is the pure-Python
parse it replaces, kept as its plain version.

TSV columns (extract_features.py:1-4,289-303):
  chrom, pos, strand, pos_in_strand, readname, read_strand, k_mer,
  signal_means (k csv, 6dp), signal_stds (k csv, 6dp), signal_lens (k csv int),
  cent_signals (s csv), methy_label

Binary record = struct ``'<{k}B{k}f{k}f{k}H{s}f1B'`` little-endian
(scripts/generate_binary_feature_file.py:52-53, unpacked by
tf_utils.py:7-28): for k=17, s=360 -> 1,628 bytes.
"""

from __future__ import annotations

import dataclasses
import os
import queue
import threading
from typing import Iterator, Optional

import numpy as np

from ..core.constants import BASE2CODE_DNA
from ..core.logging import count, span
from . import native

# the read-grouping reader (``_read_grouped_blocks``): bytes read at a time,
# chunks read ahead of the scan, room in front of a chunk for the partial
# row carried into it, how long a blocked put waits before it checks for a
# close, and the reading thread's name
GROUP_CHUNK_BYTES = 4 << 20
CHUNKS_AHEAD = 2
CARRY_ROOM = 64 << 10
CHUNK_POLL_S = 0.1
CHUNK_READER_NAME = "feature-chunks"

# k-mer encode table: A/C/G/T as the DNA codes, U as 3 (RNA k-mers), anything
# else N=4; the alphabet is chosen when the k-mer is decoded again
_PARSE_CODE_LUT = np.full(256, BASE2CODE_DNA["N"], dtype=np.int32)
for _b, _c in BASE2CODE_DNA.items():
    _PARSE_CODE_LUT[ord(_b)] = _c
_PARSE_CODE_LUT[ord("U")] = BASE2CODE_DNA["T"]


def _encode_kmer_col(kmer: str) -> np.ndarray:
    raw = np.frombuffer(kmer.encode("ascii", errors="replace"), dtype=np.uint8)
    return _PARSE_CODE_LUT[raw]


@dataclasses.dataclass
class FeatureBatch:
    """Struct-of-arrays batch of feature rows; ``sampleinfo`` keeps the
    first six TSV columns joined by tabs (call_modifications.py:51,113)."""

    sampleinfo: list         # list[str], len N
    kmers: np.ndarray        # [N, K] int
    means: np.ndarray        # [N, K] float32
    stds: np.ndarray         # [N, K] float32
    lens: np.ndarray         # [N, K] int  (signal point count per base)
    signals: np.ndarray      # [N, S] float32 (central raw signals)
    labels: np.ndarray       # [N] int

    def __len__(self) -> int:
        return len(self.sampleinfo)

    def __getitem__(self, idx) -> "FeatureBatch":
        sl = idx if isinstance(idx, slice) else slice(idx, idx + 1)
        return FeatureBatch(self.sampleinfo[sl], self.kmers[sl], self.means[sl],
                            self.stds[sl], self.lens[sl], self.signals[sl],
                            self.labels[sl])

    @staticmethod
    def concat(batches: list["FeatureBatch"]) -> "FeatureBatch":
        return FeatureBatch(
            sampleinfo=[s for b in batches for s in b.sampleinfo],
            kmers=np.concatenate([b.kmers for b in batches]),
            means=np.concatenate([b.means for b in batches]),
            stds=np.concatenate([b.stds for b in batches]),
            lens=np.concatenate([b.lens for b in batches]),
            signals=np.concatenate([b.signals for b in batches]),
            labels=np.concatenate([b.labels for b in batches]),
        )


def parse_feature_lines(lines, kmer_len: Optional[int] = None,
                        signal_len: Optional[int] = None) -> FeatureBatch:
    """Parse TSV feature lines (call_modifications.py:51-57) with the native
    block parser, at ``kmer_len``/``signal_len`` when both are given, else at
    the widths of the first row.  Rows wider than the given widths are cut
    to them; a narrower row raises ValueError, as in the JAX package's
    native parser."""
    block = "".join(l if l.endswith("\n") else l + "\n" for l in lines)
    return parse_feature_bytes(block.encode(), kmer_len, signal_len)


def parse_feature_lines_plain(lines, kmer_len: Optional[int] = None,
                              signal_len: Optional[int] = None
                              ) -> FeatureBatch:
    """The pure-Python parse of TSV feature lines, the plain version of the
    native parser.  It takes each row at its own widths and ignores
    ``kmer_len``/``signal_len``, as the JAX package's Python parse does."""
    sampleinfo = []
    kmers, means, stds, lens, signals, labels = [], [], [], [], [], []
    for line in lines:
        words = line.rstrip("\n").split("\t")
        sampleinfo.append("\t".join(words[0:6]))
        kmers.append(_encode_kmer_col(words[6]))
        means.append(np.array(words[7].split(","), dtype=np.float32))
        stds.append(np.array(words[8].split(","), dtype=np.float32))
        lens.append(np.array(words[9].split(","), dtype=np.int32))
        signals.append(np.array(words[10].split(","), dtype=np.float32))
        labels.append(int(words[11]))
    return FeatureBatch(
        sampleinfo=sampleinfo,
        kmers=np.asarray(kmers, dtype=np.int32),
        means=np.asarray(means, dtype=np.float32),
        stds=np.asarray(stds, dtype=np.float32),
        lens=np.asarray(lens, dtype=np.int32),
        signals=np.asarray(signals, dtype=np.float32),
        labels=np.asarray(labels, dtype=np.int32),
    )


def feature_widths(line: bytes) -> tuple:
    """(kmer_len, signal_len) of a feature row."""
    words = line.split(b"\t")
    if len(words) < 11:
        raise ValueError("malformed feature row at block line 0")
    return len(words[6]), words[10].count(b",") + 1


def binary_record_dtype(kmer_len: int = 17, signal_len: int = 360) -> np.dtype:
    """Packed little-endian structured dtype of the reference's binary
    record, struct format '<{k}B{k}f{k}f{k}H{s}f1B'
    (scripts/generate_binary_feature_file.py:52-53)."""
    return np.dtype([
        ("bases", "u1", (kmer_len,)),
        ("means", "<f4", (kmer_len,)),
        ("stds", "<f4", (kmer_len,)),
        ("lens", "<u2", (kmer_len,)),
        ("signals", "<f4", (signal_len,)),
        ("label", "u1"),
    ])


def binary_record_len(kmer_len: int = 17, signal_len: int = 360) -> int:
    """Record byte length (train_model.py:67-79): 11*k + 4*s + 1."""
    return kmer_len * 11 + signal_len * 4 + 1


def parse_feature_bytes(block: bytes, kmer_len: Optional[int] = None,
                        signal_len: Optional[int] = None) -> FeatureBatch:
    """Parse a bytes block of whole feature rows with the native parser;
    ``kmer_len``/``signal_len`` default to the widths of its first row."""
    if kmer_len is None or signal_len is None:
        first = _first_row(block)
        if not first:
            return parse_feature_lines_plain([])
        kmer_len, signal_len = feature_widths(first)
    return FeatureBatch(*native.parse_feature_block(block, kmer_len,
                                                    signal_len))


def _first_row(block: bytes) -> bytes:
    """The first non-empty line of a block, without its newline."""
    start = 0
    while True:
        end = block.find(b"\n", start)
        if end < 0:
            return block[start:]
        if end > start:
            return block[start:end]
        start = end + 1


def iter_feature_bytes_chunks(path: str, chunk_bytes: int = 8 << 20):
    """Stream a TSV file as line-aligned byte blocks."""
    with open(path, "rb") as rf:
        carry = b""
        while True:
            block = rf.read(chunk_bytes)
            if not block:
                if carry:
                    yield carry
                return
            block = carry + block
            cut = block.rfind(b"\n")
            if cut < 0:
                carry = block
                continue
            carry = block[cut + 1:]
            yield block[:cut + 1]


def read_binary_features(path: str, kmer_len: int = 17,
                         signal_len: int = 360) -> FeatureBatch:
    """Load a whole binary feature file (tf_utils.py:7-28 layout)."""
    rec = np.fromfile(path, dtype=binary_record_dtype(kmer_len, signal_len))
    n = rec.shape[0]
    return FeatureBatch(
        sampleinfo=[""] * n,
        kmers=rec["bases"].astype(np.int32),
        means=rec["means"].astype(np.float32),
        stds=rec["stds"].astype(np.float32),
        lens=rec["lens"].astype(np.int32),
        signals=rec["signals"].astype(np.float32),
        labels=rec["label"].astype(np.int32),
    )


def convert_txt_to_binary(txt_path: str, bin_path: str, kmer_len: int = 17,
                          signal_len: int = 360,
                          chunk_lines: int = 100000) -> int:
    """TSV features -> fixed-length binary records, streaming
    (process_utils.py:355-373); returns the record count."""
    dtype = binary_record_dtype(kmer_len, signal_len)
    total = 0
    with open(txt_path, "rb") as rf, open(bin_path, "wb") as wf:
        chunk: list = []
        for line in rf:
            chunk.append(line)
            if len(chunk) >= chunk_lines:
                total += _write_binary_chunk(chunk, wf, dtype)
                chunk = []
        if chunk:
            total += _write_binary_chunk(chunk, wf, dtype)
    return total


def _write_binary_chunk(lines: list, wf, dtype: np.dtype) -> int:
    batch = parse_feature_bytes(b"".join(lines))
    rec = np.empty(len(batch), dtype=dtype)
    rec["bases"] = batch.kmers.astype(np.uint8)
    rec["means"] = batch.means
    rec["stds"] = batch.stds
    rec["lens"] = batch.lens.astype(np.uint16)
    rec["signals"] = batch.signals
    rec["label"] = batch.labels.astype(np.uint8)
    rec.tofile(wf)
    return rec.shape[0]


def iter_feature_batches_by_read(features_file: str,
                                 reads_per_batch: int = 50,
                                 host_shard=None) -> Iterator[FeatureBatch]:
    """Stream a feature TSV grouped by read (call_modifications.py:35-91):
    a read's rows stay in one batch; a batch is emitted whenever
    ``reads_per_batch`` distinct reads have completed.

    ``host_shard=(k, n)`` keeps only every n-th read-grouped batch starting
    at k, the per-rank stride partition of a feature TSV: every rank
    computes the same global grouping, so the shards are disjoint and their
    union is exactly the unsharded stream.  The batches of other ranks are
    only scanned, never joined or parsed.

    A thread reads the file ahead in large chunks, and a native scan
    groups them (``_read_grouped_blocks``); a batch's rows go to the native
    parser as one block, with no decode and encode of each line; rows split
    by "\\n" (or "\\r\\n") give the batches the text-mode read of the JAX
    package gives.  Each batch is a ``reader.group`` span (the wait for
    the chunks that hold its rows, ``reader.chunk_wait`` inside it, and
    their grouping), a ``reader.parse`` span (``reader.native`` and
    ``reader.decode`` inside it) and a ``reader.rows`` count; one more
    ``reader.group`` span ends the stream, with what was read after the
    last batch.  The reading thread's chunks are ``reader.read`` spans.  A
    row with fewer than five fields raises ValueError."""
    blocks = _read_grouped_blocks(features_file, reads_per_batch, host_shard)
    try:
        while True:
            with span("reader.group"):
                block = next(blocks, None)
            if block is None:
                return
            with span("reader.parse"):
                fb = parse_feature_bytes(block)
            count("reader.rows", len(fb))
            yield fb
    finally:
        blocks.close()


def _read_grouped_blocks(features_file: str, reads_per_batch: int,
                         host_shard, chunk_bytes: int = GROUP_CHUNK_BYTES
                         ) -> Iterator[bytes]:
    """The rows of each of this shard's read-grouped batches, joined: the
    blocks of ``_read_grouped_blocks_plain``, byte for byte.  A thread reads
    the file ahead in chunks of ``chunk_bytes`` (``_ChunkReader``); the
    native scan (``native.find_read_batch_ends``) finds where the batches
    end, and a batch is sliced from its chunks, with no Python work a row.
    Other shards' batches are skipped, never joined.  A row with fewer than
    five fields raises ValueError with its line number, after the batches
    that end before it."""
    k, n = host_shard if host_shard is not None else (0, 1)
    chunks = _ChunkReader(features_file, chunk_bytes)
    carry = b""        # the partial last row of the chunk before
    pieces: list = []  # this shard's open batch, views of earlier chunks
    name: Optional[bytes] = None
    reads = b_num = lines = 0
    try:
        for buf, end, at_eof in chunks:
            chunk = _after_carry(carry, buf, end)
            if not chunk.size:
                continue
            ends, used, rows, name, reads, bad = native.find_read_batch_ends(
                chunk, chunk.size, at_eof, name, reads, reads_per_batch)
            view = memoryview(chunk)
            start = 0
            for stop in ends:
                if b_num % n == k:
                    pieces.append(view[start:stop])
                    yield b"".join(pieces)
                pieces = []
                b_num += 1
                start = stop
            if bad >= 0:
                raise ValueError(
                    f"malformed feature row at line {lines + bad + 1}")
            lines += rows
            if b_num % n == k and used > start:
                pieces.append(view[start:used])
            carry = view[used:].tobytes()
        if pieces:
            yield b"".join(pieces)
    finally:
        chunks.close()


def _after_carry(carry: bytes, buf: np.ndarray, end: int) -> np.ndarray:
    """The carried partial row, then the chunk ``buf[CARRY_ROOM:end]``:
    written into the room in front of the chunk where it fits."""
    if len(carry) <= CARRY_ROOM:
        lo = CARRY_ROOM - len(carry)
        buf[lo:CARRY_ROOM] = np.frombuffer(carry, np.uint8)
        return buf[lo:end]
    return np.concatenate([np.frombuffer(carry, np.uint8),
                           buf[CARRY_ROOM:end]])


class _ChunkReader:
    """The chunks of a file, read ahead by a thread of its own while the
    scan and the parse run: iterating gives ``(buf, end, at_eof)``, each
    chunk in ``buf[CARRY_ROOM:end]`` of a buffer of its own, so that a batch
    is sliced from it without a copy.  One native call reads a chunk
    (``native.read_full``: a pipe gives 64 KiB a read, and the thread takes
    the interpreter lock once a chunk), a ``reader.read`` span on the
    thread; the iteration's wait for each chunk is a ``reader.chunk_wait``
    span on the caller's thread.  An error of the thread is raised
    by the iteration.  ``close()`` stops the thread, which closes the file;
    a thread blocked on a silent pipe ends when the pipe gives data or
    ends."""

    def __init__(self, path: str, chunk_bytes: int):
        self._fd = os.open(path, os.O_RDONLY)
        self._size = CARRY_ROOM + max(int(chunk_bytes), 1)
        self._queue: queue.Queue = queue.Queue(maxsize=CHUNKS_AHEAD)
        self._stop = threading.Event()
        threading.Thread(target=self._read, name=CHUNK_READER_NAME,
                         daemon=True).start()

    def _read(self) -> None:
        try:
            at_eof = False
            while not at_eof:
                with span("reader.read"):
                    buf = np.empty(self._size, np.uint8)
                    end = CARRY_ROOM
                    while end < buf.size and not at_eof:
                        got, at_eof = native.read_full(self._fd, buf, end)
                        end += got
                if not self._put((buf, end, at_eof)):
                    return
        except Exception as exc:  # handed to the consumer, which raises it
            self._put(exc)
        finally:
            os.close(self._fd)

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=CHUNK_POLL_S)
                return True
            except queue.Full:
                pass
        return False

    def __iter__(self):
        while True:
            with span("reader.chunk_wait"):
                item = self._queue.get()
            if isinstance(item, Exception):
                raise item
            yield item
            if item[2]:
                return

    def close(self) -> None:
        self._stop.set()


def _read_grouped_blocks_plain(features_file: str, reads_per_batch: int,
                               host_shard) -> Iterator[bytes]:
    """The plain version of ``_read_grouped_blocks``: the file's lines one
    by one, each split in Python for its read name."""
    k, n = host_shard if host_shard is not None else (0, 1)
    pending: list = []
    readid_pre: Optional[bytes] = None
    r_num = 0
    b_num = 0
    with open(features_file, "rb") as rf:
        for line in rf:
            readid = line.split(b"\t", 5)[4]
            if readid_pre is None:
                readid_pre = readid
            elif readid != readid_pre:
                r_num += 1
                readid_pre = readid
                if r_num % reads_per_batch == 0:
                    if b_num % n == k:
                        yield b"".join(pending)
                    b_num += 1
                    pending = []
            if b_num % n == k:
                pending.append(line)
    if pending and b_num % n == k:
        yield b"".join(pending)


def format_feature_row(chrom: str, pos: int, strand: str, pos_in_strand: int,
                       readname: str, read_strand: str, k_mer: str,
                       signal_means, signal_stds, signal_lens,
                       cent_signals, methy_label: int) -> str:
    """One feature row as ``_features_to_str`` writes it
    (extract_features.py:289-303): means/stds rounded to 6 decimals and
    stringified with numpy float64 repr."""
    means_text = ",".join(str(x) for x in np.around(signal_means, decimals=6))
    stds_text = ",".join(str(x) for x in np.around(signal_stds, decimals=6))
    lens_text = ",".join(str(int(x)) for x in signal_lens)
    cent_text = ",".join(str(x) for x in np.asarray(cent_signals))
    return "\t".join([chrom, str(pos), strand, str(pos_in_strand), readname,
                      read_strand, k_mer, means_text, stds_text, lens_text,
                      cent_text, str(methy_label)])
