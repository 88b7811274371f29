"""The feature reader's read grouping (``io/feature_codec.py::
_read_grouped_blocks``, with the native scan ``native.find_read_batch_ends``
of ``csrc/fastparse.cpp``) against its plain version,
``_read_grouped_blocks_plain``, byte for byte: seeded TSVs read in chunks
small enough that rows and reads straddle their edges, CRLF rows, a last
row without its newline, empty and one-read files, host shards, a named
pipe, malformed rows, the reading thread's end and errors, and the
reader's spans and counts."""

import os
import threading
import time

import numpy as np
import pytest

from deepsignal_tpu_torch.core.logging import RECORD
from deepsignal_tpu_torch.io import native
from deepsignal_tpu_torch.io.feature_codec import (
    CARRY_ROOM, CHUNK_READER_NAME, GROUP_CHUNK_BYTES, _read_grouped_blocks,
    _read_grouped_blocks_plain, iter_feature_batches_by_read)
from tests import torch_tiny as tt

FIRST_ROW = -1  # a chunk size this far from the file's first row
NEXT_ROW = +1


def _rows(seed: int, n_reads: int, max_sites: int) -> list:
    """Feature-like rows: 1..max_sites a read (reads named at random, so a
    name may come back after another read), the read name in the fifth
    field, and a tail of random length."""
    rng = np.random.default_rng(seed)
    rows = []
    for r in range(n_reads):
        name = f"read{rng.integers(0, n_reads // 2 + 2)}"
        for j in range(int(rng.integers(1, max_sites + 1))):
            tail = "x" * int(rng.integers(0, 60))
            rows.append(f"chr1\t{j}\t+\t{j}\t{name}\tt\tACGTA\t{tail}\t1\n")
    return rows


def _write(tmp_path, rows, name="f.tsv") -> str:
    path = tmp_path / name
    if isinstance(rows, list):
        rows = "".join(rows)
    path.write_bytes(rows.encode() if isinstance(rows, str) else rows)
    return str(path)


def _chunk(rows, chunk) -> int:
    if chunk in (FIRST_ROW, NEXT_ROW):
        return len(rows[0]) + chunk
    return chunk


def _both(path, reads_per_batch, host_shard=None, chunk=GROUP_CHUNK_BYTES):
    want = list(_read_grouped_blocks_plain(path, reads_per_batch,
                                           host_shard))
    got = list(_read_grouped_blocks(path, reads_per_batch, host_shard,
                                    chunk))
    return got, want


@pytest.mark.parametrize("chunk", [FIRST_ROW, NEXT_ROW, 1024,
                                   GROUP_CHUNK_BYTES])
@pytest.mark.parametrize("reads_per_batch", [1, 2, 50])
@pytest.mark.parametrize("seed", [0, 1])
def test_native_grouping_equals_the_plain_grouping(tmp_path, seed,
                                                   reads_per_batch, chunk):
    # rows of about the chunk's size take a scan each: fewer of them there
    rows = _rows(seed, 150, 200 if chunk > 0 else 12)
    path = _write(tmp_path, rows)
    got, want = _both(path, reads_per_batch, chunk=_chunk(rows, chunk))
    assert len(want) > 1
    assert got == want
    assert b"".join(got) == "".join(rows).encode()


@pytest.mark.parametrize("chunk", [FIRST_ROW, NEXT_ROW, 1024])
@pytest.mark.parametrize("case", ["crlf", "no_last_newline",
                                  "crlf_no_last_newline", "one_read",
                                  "one_row", "five_fields", "long_rows"])
def test_edge_files_group_as_the_plain_grouping(tmp_path, case, chunk):
    rows = _rows(7, 30, 12)
    if case.startswith("crlf"):
        rows = [r.replace("\n", "\r\n") for r in rows]
    if case.endswith("no_last_newline"):
        rows[-1] = rows[-1].rstrip("\r\n")
    if case == "one_read":
        rows = ["\t".join(f[:4] + ["one"] + f[5:])
                for f in (r.split("\t") for r in rows)]
    if case == "one_row":
        rows = rows[:1]
    if case == "five_fields":  # the name runs to the row's end, newline too
        rows = [r if i % 3 else "\t".join(r.split("\t")[:5]) + "\n"
                for i, r in enumerate(rows)]
    if case == "long_rows":  # longer than the room kept for a carried row
        rows = [r.replace("\tt\t", "\t" + "y" * (CARRY_ROOM + i) + "\t")
                if i in (3, 40) else r for i, r in enumerate(rows)]
    path = _write(tmp_path, rows)
    for reads_per_batch in (1, 2, 50):
        got, want = _both(path, reads_per_batch, chunk=_chunk(rows, chunk))
        assert got == want, reads_per_batch
        assert b"".join(got) == "".join(rows).encode()
    if case in ("one_read", "one_row"):
        assert len(got) == 1


def test_an_empty_file_gives_no_batch(tmp_path):
    path = _write(tmp_path, b"")
    for chunk in (1, 1024, GROUP_CHUNK_BYTES):
        assert _both(path, 2, chunk=chunk) == ([], [])
    assert list(iter_feature_batches_by_read(path, 2)) == []


@pytest.mark.parametrize("chunk", [FIRST_ROW, 1024, GROUP_CHUNK_BYTES])
@pytest.mark.parametrize("n", [1, 2, 3])
def test_host_shards_are_the_plain_shards_and_cover_the_stream(
        tmp_path, n, chunk):
    rows = _rows(3, 60, 30)
    path = _write(tmp_path, rows)
    chunk = _chunk(rows, chunk)
    whole = list(_read_grouped_blocks(path, 2, None, chunk))
    shards = []
    for k in range(n):
        got, want = _both(path, 2, (k, n), chunk)
        assert got == want
        shards.append(got)
    # the stride partition: batch i is shard i % n's (i // n)-th batch
    assert [shards[i % n][i // n] for i in range(len(whole))] == whole
    assert sum(map(len, shards)) == len(whole)


def test_a_named_pipe_groups_as_the_file(tmp_path):
    """A pipe gives a read at most its own buffer: the reader fills its
    chunk with many reads, here from a writer that writes 1,000 bytes at a
    time."""
    rows = _rows(5, 120, 80)
    data = "".join(rows).encode()
    path = _write(tmp_path, rows)
    fifo = str(tmp_path / "f.fifo")
    os.mkfifo(fifo)

    def write():
        with open(fifo, "wb", buffering=0) as f:
            for i in range(0, len(data), 1000):
                f.write(data[i:i + 1000])

    writer = threading.Thread(target=write, daemon=True)
    writer.start()
    got = list(_read_grouped_blocks(fifo, 3, None, 64 << 10))
    writer.join(30)
    assert not writer.is_alive()
    assert got == list(_read_grouped_blocks_plain(path, 3, None))


@pytest.mark.parametrize("chunk", [FIRST_ROW, 1024, GROUP_CHUNK_BYTES])
@pytest.mark.parametrize("bad", ["four_fields", "empty_line", "no_tab"])
def test_a_row_with_fewer_than_five_fields_raises_naming_its_line(
        tmp_path, bad, chunk):
    rows = _rows(11, 40, 10)
    at = len(rows) * 2 // 3
    rows.insert(at, {"four_fields": "chr1\t1\t+\t1\n", "empty_line": "\n",
                     "no_tab": "garbage\n"}[bad])
    path = _write(tmp_path, rows)
    # the plain grouping fails at the same row, with an IndexError
    want = []
    with pytest.raises(IndexError):
        for block in _read_grouped_blocks_plain(path, 1, None):
            want.append(block)
    got = []
    with pytest.raises(ValueError,
                       match=f"^malformed feature row at line {at + 1}$"):
        for block in _read_grouped_blocks(path, 1, None,
                                          _chunk(rows, chunk)):
            got.append(block)
    # the batches that end before the row come first
    assert got == want and len(got) > 1


def test_a_malformed_row_raises_through_the_reader(tmp_path):
    rows = tt.tiny_feature_rows(n=12)
    path = _write(tmp_path, "\n".join(rows[:7] + ["a\tb"] + rows[7:]) + "\n")
    with pytest.raises(ValueError, match="malformed feature row at line 8"):
        list(iter_feature_batches_by_read(path, 1))


def test_one_group_span_per_batch_and_one_at_the_end(tmp_path):
    path = _write(tmp_path, "\n".join(tt.tiny_feature_rows(n=40)) + "\n")
    t0 = time.perf_counter()
    n = 0
    for n, fb in enumerate(iter_feature_batches_by_read(path, 1), 1):
        assert len(RECORD.within("reader.group", t0,
                                 time.perf_counter())) == n
    assert n == 7  # 6 sites a read
    t1 = time.perf_counter()
    # one more reads the end of the file
    assert len(RECORD.within("reader.group", t0, t1)) == n + 1
    assert len(RECORD.within("reader.parse", t0, t1)) == n


@pytest.mark.parametrize("chunk_rows, n_calls", [(1, 40), (4, 10), (7, 6),
                                                 (40, 1), (41, 1)])
def test_the_scan_counts_one_call_a_chunk(tmp_path, chunk_rows, n_calls):
    """Rows of one length: every chunk but the last holds ``chunk_rows``
    whole rows, so the file takes ceil(40 / chunk_rows) scans."""
    rows = [f"c\t{i:03d}\t+\t0\tread{i // 3:02d}\tt\tACGTA\t1\n"
            for i in range(40)]
    assert len(set(map(len, rows))) == 1
    path = _write(tmp_path, rows)
    before = native.find_read_batch_ends.calls
    got = list(_read_grouped_blocks(path, 2, None, chunk_rows * len(rows[0])))
    assert native.find_read_batch_ends.calls - before == n_calls
    assert got == list(_read_grouped_blocks_plain(path, 2, None))


def test_the_scan_carries_the_read_name_and_count_across_chunks():
    row = b"a\tb\tc\td\tr1\tx\n"
    rows = row * 2 + b"a\tb\tc\td\tr2\tx\na\tb\tc\td\tr3"
    chunk = np.frombuffer(rows, np.uint8).copy()
    # without the end of the input the last row is left for the next chunk
    ends, used, n_rows, name, reads, bad = native.find_read_batch_ends(
        chunk, chunk.size, False, b"r0", 4, 5)
    assert (ends, n_rows, name, reads, bad) == ([0], 3, b"r2", 6, -1)
    assert used == rows.rindex(b"\n") + 1
    # at the end of the input it is scanned; the name goes to the end
    ends, used, n_rows, name, reads, bad = native.find_read_batch_ends(
        chunk, chunk.size, True, b"r1", 0, 1)
    assert (ends, used, n_rows, name, reads, bad) == \
        ([2 * len(row), 3 * len(row)], chunk.size, 4, b"r3", 2, -1)
    # no row: the name and the count come back as they went in
    assert native.find_read_batch_ends(chunk, 0, True, b"r9", 3, 2) == \
        ([], 0, 0, b"r9", 3, -1)
    with pytest.raises(ValueError, match="reads_per_batch"):
        native.find_read_batch_ends(chunk, chunk.size, True, None, 0, 0)
    with pytest.raises(ValueError, match="length"):
        native.find_read_batch_ends(chunk, chunk.size + 1, True, None, 0, 1)


def _chunk_threads(wait_s: float = 0.0) -> list:
    """The live reading threads, after waiting up to ``wait_s`` for them
    to end."""
    deadline = time.monotonic() + wait_s
    while True:
        alive = [t for t in threading.enumerate()
                 if t.name == CHUNK_READER_NAME and t.is_alive()]
        if not alive or time.monotonic() >= deadline:
            return alive
        time.sleep(0.01)


def test_closing_early_stops_the_reading_thread(tmp_path):
    rows = _rows(13, 200, 30)
    path = _write(tmp_path, rows)
    assert _chunk_threads(10) == []
    blocks = _read_grouped_blocks(path, 1, None, 1024)
    first = next(blocks)
    assert first == next(_read_grouped_blocks_plain(path, 1, None))
    # the thread has filled the chunks it may hold ahead and waits
    assert len(_chunk_threads()) == 1
    blocks.close()
    assert _chunk_threads(10) == []


def test_a_read_error_of_the_thread_raises_in_the_reader(tmp_path):
    with pytest.raises(IsADirectoryError):
        list(_read_grouped_blocks_plain(str(tmp_path), 2, None))
    with pytest.raises(IsADirectoryError):
        list(_read_grouped_blocks(str(tmp_path), 2, None))
    with pytest.raises(FileNotFoundError):
        list(_read_grouped_blocks(str(tmp_path / "none.tsv"), 2, None))
    assert _chunk_threads(10) == []


def test_read_full_reads_to_the_end_of_a_pipe(tmp_path):
    data = bytes(range(256)) * 1000
    r, w = os.pipe()

    def write():
        with os.fdopen(w, "wb", buffering=0) as f:
            for i in range(0, len(data), 4000):
                f.write(data[i:i + 4000])

    writer = threading.Thread(target=write, daemon=True)
    writer.start()
    try:
        buf = np.zeros(len(data) + 10, np.uint8)
        # full before the end: many of the pipe's reads in one call
        assert native.read_full(r, buf[:100_000], 0) == (100_000, False)
        got, at_eof = native.read_full(r, buf, 100_000)
        assert (got, at_eof) == (len(data) - 100_000, True)
        assert buf[:len(data)].tobytes() == data
    finally:
        os.close(r)
    writer.join(10)
    assert not writer.is_alive()
    with pytest.raises(ValueError, match="start"):
        native.read_full(0, buf, buf.size + 1)
