"""ctypes bindings of the port's host C++ code.

- ``parse_feature_block``: the feature-TSV block parser
  (``csrc/fastparse.cpp``), a copy of the reference package's
  ``native/fastparse.cpp``; ``read_full`` and ``find_read_batch_ends``,
  in the same library, the reading and read grouping of the TSV reader;
- ``format_call_block``, ``count_read_runs``, ``repr_f32``: the call-row
  formatter (``csrc/callfmt.cpp``), a copy of the call-row half of its
  ``native/featkernel.cpp``;
- ``segment_stats``, ``format_rows6``: the featurizer
  kernels (``csrc/featkernel.cpp``), a copy of the extract half of that
  file.

The libraries are built with the host compiler at first use
(``ops/cuda/build.py``) and loaded with ctypes; a failed build raises.
Every output is allocated here and checked for size before a pointer goes
to the C side.  ``parse_feature_block``, ``read_full``,
``find_read_batch_ends``, ``format_call_block``, ``count_read_runs``,
``segment_stats`` and ``format_rows6`` count their calls (``.calls``), so
a run can show that it went through the native code.  This module imports
numpy only (and the port's torch-free ``core.logging``).
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import Optional

import numpy as np

from ..core.logging import span
from ..ops.cuda.build import load_library

_PTR = ctypes.c_void_p
_I64 = ctypes.c_int64
_I32 = ctypes.c_int32
_F64 = ctypes.c_double

PARSER_LIBRARY = "fastparse"
FORMATTER_LIBRARY = "callfmt"
FEATURIZER_LIBRARY = "featkernel"
# the longest str(np.float32) the formatter writes (csrc/callfmt.cpp)
MAX_REPR = 24
# the longest str(np.float64) the featurizer writes (csrc/featkernel.cpp)
MAX_REPR6 = 32

_PARSE_ERRORS = {1: "malformed feature row at block line %d",
                 2: "malformed numeric field at block line %d",
                 3: "malformed label at block line %d"}


@functools.cache
def _fastparse() -> ctypes.CDLL:
    lib = load_library(PARSER_LIBRARY)
    lib.ds_count_feature_rows.argtypes = [ctypes.c_char_p, _I64]
    lib.ds_count_feature_rows.restype = _I64
    lib.ds_parse_feature_block.argtypes = [
        ctypes.c_char_p, _I64, _I32, _I32, _I64, _PTR, _PTR, _PTR, _PTR,
        _PTR, _PTR, _PTR, ctypes.POINTER(_I64)]
    lib.ds_parse_feature_block.restype = ctypes.c_int
    lib.ds_find_read_batch_ends.argtypes = [
        _PTR, _I64, _I32, ctypes.c_char_p, _I64, _I64, _PTR, _I64, _PTR]
    lib.ds_find_read_batch_ends.restype = _I64
    lib.ds_read_full.argtypes = [_I32, _PTR, _I64, ctypes.POINTER(_I32)]
    lib.ds_read_full.restype = _I64
    return lib


@functools.cache
def _callfmt() -> ctypes.CDLL:
    lib = load_library(FORMATTER_LIBRARY)
    lib.ds_repr_f32.argtypes = [_PTR, _I64, _PTR, _I64, _PTR, _F64, _F64]
    lib.ds_repr_f32.restype = _I64
    lib.ds_format_call_block.argtypes = [
        ctypes.c_char_p, _PTR, _PTR, _PTR, _PTR, _PTR, _I64, _I64,
        ctypes.c_char_p, _PTR, _I64, _F64, _F64]
    lib.ds_format_call_block.restype = _I64
    lib.ds_count_read_runs.argtypes = [ctypes.c_char_p, _PTR, _I64, _PTR]
    lib.ds_count_read_runs.restype = _I64
    return lib


@functools.cache
def _featkernel() -> ctypes.CDLL:
    lib = load_library(FEATURIZER_LIBRARY)
    lib.ds_segment_stats.argtypes = [_PTR, _I64, _PTR, _PTR, _I64, _PTR,
                                     _PTR]
    lib.ds_segment_stats.restype = _I64
    lib.ds_format_rows6.argtypes = [_PTR, _I64, _I64, _PTR, _I64, _PTR, _F64,
                                    _F64]
    lib.ds_format_rows6.restype = _I64
    return lib


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


@functools.cache
def positional_range(dtype=np.float32) -> tuple:
    """(lo, hi): the installed numpy prints a scalar of ``dtype`` (float32
    or float64) in positional notation for lo <= |x| < hi and in scientific
    notation elsewhere.  numpy 2.0 gives (1e-4, 1e16) for both, the range
    the JAX package's formatters hardcode; later versions switch float32 to
    scientific notation lower (1e8 printed as "1e+08").  Found at powers of
    ten (float32 holds 10**k exactly for k <= 10; just above 10**-k for the
    lower bound); the formatters' checks at first use hold the result
    against numpy."""
    def positional(x) -> bool:
        return "e" not in str(x)

    hi = next((10.0 ** k for k in range(1, 17)
               if not positional(dtype(10.0 ** k))), 1e16)
    lo = 1.0
    for k in range(1, 13):
        if not positional(np.nextafter(dtype(10.0 ** -k), dtype(1))):
            break
        lo = 10.0 ** -k
    return lo, hi


def segment_stats(norm: np.ndarray, starts: np.ndarray, lengths: np.ndarray):
    """(means, stds) float64 [m]: np.mean and np.std of every segment
    ``norm[starts[i]:starts[i] + lengths[i]]``, in numpy's summation order.
    A segment that is empty or runs outside ``norm`` raises ValueError."""
    x = np.ascontiguousarray(norm, dtype=np.float64)
    st = np.ascontiguousarray(starts, dtype=np.int64)
    ln = np.ascontiguousarray(lengths, dtype=np.int64)
    if st.shape != ln.shape:
        raise ValueError("starts/lens length mismatch")
    m = st.size
    means = np.empty(m, np.float64)
    stds = np.empty(m, np.float64)
    bad = _featkernel().ds_segment_stats(_ptr(x), x.size, _ptr(st), _ptr(ln),
                                         m, _ptr(means), _ptr(stds))
    if bad:
        i = bad - 1
        raise ValueError(f"segment {i} out of bounds (start={st[i]} "
                         f"len={ln[i]} n={x.size})")
    segment_stats.calls += 1
    return means, stds


def format_rows6(x) -> list:
    """Each row of the [S, K] float64 matrix ``x`` (values already rounded
    to 6 decimals) as ``",".join(str(v) for v in row)``, in the installed
    numpy's float64 positional range (``positional_range``)."""
    lo, hi = positional_range(np.float64)
    if not (1e-12 <= lo and hi <= 1e16):  # what MAX_REPR6 holds
        raise ValueError(f"positional range {lo}, {hi} outside 1e-12..1e16")
    x = np.ascontiguousarray(x, dtype=np.float64)
    if x.ndim != 2:
        raise ValueError("format_rows6 expects a 2-D array")
    s, k = x.shape
    cap = s * k * (MAX_REPR6 + 1)
    out = np.empty(max(cap, 1), np.uint8)
    ends = np.empty(s, np.int64)
    w = _featkernel().ds_format_rows6(_ptr(x), s, k, _ptr(out), cap,
                                      _ptr(ends), lo, hi)
    if w < 0:
        raise RuntimeError("ds_format_rows6: output buffer too small")
    format_rows6.calls += 1
    text = out[:w].tobytes().decode("ascii")
    starts = [0, *ends[:-1].tolist()]
    return [text[a:b] for a, b in zip(starts, ends.tolist())]


def parse_feature_block(block: bytes, kmer_len: int, signal_len: int):
    """The non-empty lines of ``block`` as (sampleinfo, kmers, means, stds,
    lens, signals, labels): sampleinfo a list of str (the first six columns
    joined by tabs), kmers and lens [N, kmer_len] int32, means and stds
    [N, kmer_len] float32, signals [N, signal_len] float32, labels [N]
    int32.  A malformed row raises ValueError with its line number.  The
    two native calls, with the allocation of their outputs, are a
    ``reader.native`` span, the decode of the sampleinfo strings a
    ``reader.decode`` span."""
    block = bytes(block)  # a bytes object ends in the NUL the parser needs
    k, s = int(kmer_len), int(signal_len)
    if k < 0 or s < 0:
        raise ValueError(f"kmer_len {k} and signal_len {s} must be >= 0")
    lib = _fastparse()
    with span("reader.native"):
        n = lib.ds_count_feature_rows(block, len(block))
        kmers = np.empty((n, k), np.int32)
        means = np.empty((n, k), np.float32)
        stds = np.empty((n, k), np.float32)
        lens = np.empty((n, k), np.int32)
        signals = np.empty((n, s), np.float32)
        labels = np.empty(n, np.int32)
        info = np.empty((n, 2), np.int64)
        bad = _I64(0)
        rc = lib.ds_parse_feature_block(
            block, len(block), k, s, n, _ptr(kmers), _ptr(means),
            _ptr(stds), _ptr(lens), _ptr(signals), _ptr(labels), _ptr(info),
            ctypes.byref(bad))
    if rc in _PARSE_ERRORS:
        raise ValueError(_PARSE_ERRORS[rc] % bad.value)
    if rc != 0:
        raise RuntimeError(f"ds_parse_feature_block returned {rc}")
    parse_feature_block.calls += 1
    with span("reader.decode"):
        sampleinfo = [block[a:b].decode() for a, b in info.tolist()]
    return sampleinfo, kmers, means, stds, lens, signals, labels


def read_full(fd: int, buf: np.ndarray, start: int) -> tuple:
    """Read the file descriptor ``fd`` into ``buf[start:]`` (uint8) until
    the buffer is full or the input ends, in one native call.  Returns
    ``(bytes read, whether the input ended)``; an interrupted read returns
    what it read so far and False, so that the caller's signal handlers
    run before it calls again.  An error raises OSError."""
    if buf.dtype != np.uint8 or buf.ndim != 1 or not buf.flags.c_contiguous \
            or not buf.flags.writeable:
        raise ValueError("buf must be a writeable contiguous 1-D uint8 "
                         "array")
    if not 0 <= start <= buf.size:
        raise ValueError(f"start {start} outside the buffer's {buf.size} "
                         f"bytes")
    at_eof = _I32(0)
    got = _fastparse().ds_read_full(fd, _ptr(buf) + start, buf.size - start,
                                    ctypes.byref(at_eof))
    if got < 0:
        raise OSError(-got, os.strerror(-got))
    read_full.calls += 1
    return got, bool(at_eof.value)


def find_read_batch_ends(chunk: np.ndarray, length: int, at_eof: bool,
                         prev_name: Optional[bytes], reads_done: int,
                         reads_per_batch: int) -> tuple:
    """Where read-grouped batches end in the feature rows of
    ``chunk[:length]`` (uint8), rows in file order: a batch ends where the
    ``reads_per_batch``-th, 2 * ``reads_per_batch``-th, ... change of read
    name (the fifth tab field, as ``line.split(b"\t", 5)[4]``) begins.
    ``prev_name`` is the read name of the row before the chunk (None before
    the file's first row) and ``reads_done`` the changes of read counted
    before it.  A last row without its newline is scanned only ``at_eof``.

    Returns ``(ends, used, rows, last_name, reads_done, bad_row)``: the
    batch ends as a list of offsets of the chunk, the bytes and the count
    of the rows scanned, the read name of the last of them (``prev_name``
    when none was), the changes of read counted so far, and the chunk's
    first row with fewer than five fields (-1 for none), where the scan
    stopped."""
    if chunk.dtype != np.uint8 or chunk.ndim != 1 or \
            not chunk.flags.c_contiguous:
        raise ValueError("chunk must be a contiguous 1-D uint8 array")
    if not 0 <= length <= chunk.size:
        raise ValueError(f"length {length} outside the chunk's "
                         f"{chunk.size} bytes")
    if reads_per_batch < 1:
        raise ValueError(f"reads_per_batch {reads_per_batch} must be >= 1")
    # every row but the last holds four tabs and a newline
    cap = length // 5 + 1
    ends = np.empty(cap, np.int64)
    state = np.array([reads_done, 0, 0, 0, 0, 0], np.int64)
    prev_len = -1 if prev_name is None else len(prev_name)
    n = _fastparse().ds_find_read_batch_ends(
        _ptr(chunk), length, int(at_eof), prev_name, prev_len,
        reads_per_batch, _ptr(ends), cap, _ptr(state))
    if n < 0:
        raise RuntimeError("ds_find_read_batch_ends: more ends than rows")
    find_read_batch_ends.calls += 1
    reads_done, start, stop, used, rows, bad_row = state.tolist()
    if start >= 0:
        prev_name = chunk[start:stop].tobytes()
    return ends[:n].tolist(), used, rows, prev_name, reads_done, bad_row


def _join(strings) -> tuple:
    """Strings -> (one utf-8 buffer, [n + 1] int64 byte offsets)."""
    enc = [s.encode() for s in strings]
    offs = np.zeros(len(enc) + 1, np.int64)
    np.cumsum(np.fromiter(map(len, enc), np.int64, len(enc)), out=offs[1:])
    return b"".join(enc), offs


def format_call_block(sampleinfo: list, p0, p1, pred, kmers,
                      lut: np.ndarray) -> bytes:
    """All call rows "info\\tp0\\tp1\\tpred\\tkmer\\n" of a batch as one
    block, the probabilities as ``str(np.float32)``; ``lut`` maps the 256
    uint8 k-mer codes to letters."""
    p0 = np.ascontiguousarray(p0, dtype=np.float32).ravel()
    p1 = np.ascontiguousarray(p1, dtype=np.float32).ravel()
    pred = np.ascontiguousarray(pred, dtype=np.int64).ravel()
    kmers = np.ascontiguousarray(kmers).astype(np.uint8, copy=False)
    lut = np.ascontiguousarray(lut, dtype=np.uint8)
    n = len(sampleinfo)
    if (p0.size != n or p1.size != n or pred.size != n or kmers.ndim != 2
            or kmers.shape[0] != n):
        raise ValueError("format_call_block: length mismatch across inputs")
    if lut.size != 256:
        raise ValueError("lut must be 256 bytes")
    info, offs = _join(sampleinfo)
    k = kmers.shape[1]
    cap = len(info) + n * (2 * MAX_REPR + k + 28)
    out = np.empty(cap, np.uint8)
    w = _callfmt().ds_format_call_block(
        info, _ptr(offs), _ptr(p0), _ptr(p1), _ptr(pred), _ptr(kmers), n, k,
        lut.tobytes(), _ptr(out), cap, *positional_range())
    if w < 0:
        raise RuntimeError("ds_format_call_block: output buffer too small")
    format_call_block.calls += 1
    return out[:w].tobytes()


def count_read_runs(sampleinfo: list) -> tuple:
    """(n_runs, first_read, last_read) over the contiguous same-read runs of
    a batch's sampleinfo (read name = the 5th tab field); a string without
    its 6 tab-separated fields raises ValueError."""
    info, offs = _join(sampleinfo)
    names = np.zeros(4, np.int64)
    runs = _callfmt().ds_count_read_runs(info, _ptr(offs), len(sampleinfo),
                                         _ptr(names))
    if runs < 0:
        raise ValueError(f"sampleinfo {-runs - 1} has fewer than 6 fields: "
                         f"{sampleinfo[-runs - 1]!r}")
    count_read_runs.calls += 1
    a, b, c, d = names.tolist()
    return runs, info[a:b].decode(), info[c:d].decode()


def repr_f32(x, positional=None) -> list:
    """``str(np.float32(v))`` of every element of ``x``; ``positional`` is
    the (lo, hi) of ``positional_range``, by default the installed
    numpy's."""
    lo, hi = positional or positional_range()
    if not (1e-12 <= lo and hi <= 1e16):  # what MAX_REPR holds
        raise ValueError(f"positional range {lo}, {hi} outside 1e-12..1e16")
    x = np.ascontiguousarray(x, dtype=np.float32).ravel()
    n = x.size
    cap = n * MAX_REPR
    out = np.empty(max(cap, 1), np.uint8)
    ends = np.empty(n, np.int64)
    w = _callfmt().ds_repr_f32(_ptr(x), n, _ptr(out), cap, _ptr(ends), lo,
                               hi)
    if w < 0:
        raise RuntimeError("ds_repr_f32: output buffer too small")
    text = out[:w].tobytes().decode("ascii")
    starts = [0, *ends[:-1].tolist()]
    return [text[a:b] for a, b in zip(starts, ends.tolist())]


# calls since the last reset, counted where the native code ran
parse_feature_block.calls = 0
find_read_batch_ends.calls = 0
read_full.calls = 0
format_call_block.calls = 0
count_read_runs.calls = 0
segment_stats.calls = 0
format_rows6.calls = 0
