"""The subset of msgpack that ``flax.serialization.to_bytes`` writes.

A checkpoint's ``variables.msgpack`` is a msgpack map of maps whose leaves
are numpy arrays, packed as msgpack ext type 1 around a nested msgpack
array ``(shape, dtype_name, raw C-order bytes)``; numpy scalars use ext type
3 the same way.  Arrays above 2**30 bytes are split by flax into
``{"__msgpack_chunked_array__": True, "shape": {...}, "chunks": {...}}``
maps of flat pieces (tuples become maps keyed "0", "1", ...).

``packb`` picks the smallest encoding of each value, as the msgpack package
does, so its output for a tree of dicts and arrays equals flax's byte for
byte.  No other part of msgpack (timestamps, complex numbers) is read or
written.
"""

from __future__ import annotations

import struct

import numpy as np

EXT_NDARRAY = 1
EXT_NPSCALAR = 3
CHUNKED_KEY = "__msgpack_chunked_array__"
MAX_CHUNK_SIZE = 2 ** 30  # flax's chunking threshold, in bytes


# --------------------------------------------------------------------------
# encoder


def _pack_uint_header(out: bytearray, n: int, fix_base: int, fix_max: int,
                      codes) -> None:
    """Length header: fix form below ``fix_max``, else 8/16/32-bit form
    (``codes`` = (c8 or None, c16, c32))."""
    c8, c16, c32 = codes
    if n < fix_max:
        out.append(fix_base | n)
    elif c8 is not None and n < 2 ** 8:
        out += bytes((c8, n))
    elif n < 2 ** 16:
        out.append(c16)
        out += struct.pack(">H", n)
    else:
        out.append(c32)
        out += struct.pack(">I", n)


def _pack_int(out: bytearray, v: int) -> None:
    if 0 <= v < 128:
        out.append(v)
    elif -32 <= v < 0:
        out.append(v & 0xFF)
    elif v >= 0:
        for code, fmt, lim in ((0xCC, ">B", 2 ** 8), (0xCD, ">H", 2 ** 16),
                               (0xCE, ">I", 2 ** 32), (0xCF, ">Q", 2 ** 64)):
            if v < lim:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise OverflowError(v)
    else:
        for code, fmt, lim in ((0xD0, ">b", 2 ** 7), (0xD1, ">h", 2 ** 15),
                               (0xD2, ">i", 2 ** 31), (0xD3, ">q", 2 ** 63)):
            if v >= -lim:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise OverflowError(v)


def _pack_bin(out: bytearray, data: bytes) -> None:
    n = len(data)
    if n < 2 ** 8:
        out += bytes((0xC4, n))
    elif n < 2 ** 16:
        out.append(0xC5)
        out += struct.pack(">H", n)
    else:
        out.append(0xC6)
        out += struct.pack(">I", n)
    out += data


def _pack_ext(out: bytearray, code: int, data: bytes) -> None:
    n = len(data)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        out += bytes((fixed[n], code))
    elif n < 2 ** 8:
        out += bytes((0xC7, n, code))
    elif n < 2 ** 16:
        out.append(0xC8)
        out += struct.pack(">H", n)
        out.append(code)
    else:
        out.append(0xC9)
        out += struct.pack(">I", n)
        out.append(code)
    out += data


def _ndarray_bytes(arr: np.ndarray) -> bytes:
    if arr.dtype.hasobject or arr.dtype.fields is not None:
        raise ValueError("object and structured dtypes are not supported")
    return packb((list(arr.shape), arr.dtype.name, arr.tobytes("C")))


def _pack(out: bytearray, v) -> None:
    if v is None:
        out.append(0xC0)
    elif v is True:
        out.append(0xC3)
    elif v is False:
        out.append(0xC2)
    elif type(v) is int:
        _pack_int(out, v)
    elif type(v) is float:
        out.append(0xCB)
        out += struct.pack(">d", v)
    elif type(v) is str:
        data = v.encode("utf-8")
        _pack_uint_header(out, len(data), 0xA0, 32, (0xD9, 0xDA, 0xDB))
        out += data
    elif type(v) in (bytes, bytearray, memoryview):
        _pack_bin(out, bytes(v))
    elif type(v) in (list, tuple):
        _pack_uint_header(out, len(v), 0x90, 16, (None, 0xDC, 0xDD))
        for item in v:
            _pack(out, item)
    elif type(v) is dict:
        _pack_uint_header(out, len(v), 0x80, 16, (None, 0xDE, 0xDF))
        for key, item in v.items():
            _pack(out, key)
            _pack(out, item)
    elif isinstance(v, np.ndarray):
        _pack_ext(out, EXT_NDARRAY, _ndarray_bytes(v))
    elif isinstance(v, np.generic):
        _pack_ext(out, EXT_NPSCALAR, _ndarray_bytes(np.asarray(v)))
    else:
        raise TypeError(f"cannot msgpack {type(v).__name__}")


def packb(obj) -> bytes:
    """Encode ``obj`` (dict/list/tuple/str/bytes/int/float/bool/None and
    numpy arrays or scalars)."""
    out = bytearray()
    _pack(out, obj)
    return bytes(out)


def _chunk(arr: np.ndarray) -> dict:
    chunksize = max(1, MAX_CHUNK_SIZE // arr.dtype.itemsize)
    flat = arr.reshape(-1)
    chunks = [flat[i:i + chunksize] for i in range(0, flat.size, chunksize)]
    return {CHUNKED_KEY: True,
            "shape": {str(i): n for i, n in enumerate(arr.shape)},
            "chunks": {str(i): c for i, c in enumerate(chunks)}}


def _chunk_tree(tree):
    if isinstance(tree, dict):
        return {k: _chunk_tree(v) for k, v in tree.items()}
    if isinstance(tree, np.ndarray) and tree.nbytes > MAX_CHUNK_SIZE:
        return _chunk(tree)
    return tree


def serialize_tree(tree) -> bytes:
    """``flax.serialization.msgpack_serialize`` of a nested dict of numpy
    arrays: oversized arrays chunked, then packed."""
    return packb(_chunk_tree(tree))


# --------------------------------------------------------------------------
# decoder


class _Reader:
    def __init__(self, data):
        self.buf = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        view = self.buf[self.pos:self.pos + n]
        self.pos += n
        return view

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self):
        code = self.take(1)[0]
        if code <= 0x7F:
            return code
        if code >= 0xE0:
            return code - 0x100
        if 0x80 <= code <= 0x8F:
            return self.map(code & 0x0F)
        if 0x90 <= code <= 0x9F:
            return self.array(code & 0x0F)
        if 0xA0 <= code <= 0xBF:
            return str(self.take(code & 0x1F), "utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if code in simple:
            return simple[code]
        sized = {  # code -> (length format, kind)
            0xC4: (">B", "bin"), 0xC5: (">H", "bin"), 0xC6: (">I", "bin"),
            0xD9: (">B", "str"), 0xDA: (">H", "str"), 0xDB: (">I", "str"),
            0xDC: (">H", "array"), 0xDD: (">I", "array"),
            0xDE: (">H", "map"), 0xDF: (">I", "map"),
            0xC7: (">B", "ext"), 0xC8: (">H", "ext"), 0xC9: (">I", "ext")}
        if code in sized:
            fmt, kind = sized[code]
            n = self.unpack(fmt)
            if kind == "bin":
                return self.take(n)
            if kind == "str":
                return str(self.take(n), "utf-8")
            if kind == "array":
                return self.array(n)
            if kind == "map":
                return self.map(n)
            return self.ext(n)
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if code in fixext:
            return self.ext(fixext[code])
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
                   0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if code in numbers:
            return self.unpack(numbers[code])
        raise ValueError(f"unsupported msgpack type byte 0x{code:02x}")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out

    def ext(self, n: int):
        code = self.unpack(">b")
        data = self.take(n)
        if code not in (EXT_NDARRAY, EXT_NPSCALAR):
            raise ValueError(f"unsupported msgpack ext type {code}")
        shape, dtype_name, raw = unpackb(data)
        arr = np.frombuffer(raw, dtype=_dtype(dtype_name)).reshape(shape)
        return arr[()] if code == EXT_NPSCALAR else arr


def _dtype(name: str) -> np.dtype:
    if name == "bfloat16":
        raise ValueError("bfloat16 arrays in checkpoints are not supported; "
                         "parameters are stored as float32")
    return np.dtype(name)


def unpackb(data):
    """Decode one msgpack value.  Arrays are read-only views of ``data``."""
    reader = _Reader(data)
    out = reader.value()
    if reader.pos != len(reader.buf):
        raise ValueError("trailing bytes after msgpack value")
    return out


def _unchunk_tree(tree):
    if not isinstance(tree, dict):
        return tree
    if CHUNKED_KEY in tree:
        shape = [tree["shape"][str(i)] for i in range(len(tree["shape"]))]
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk_tree(v) for k, v in tree.items()}


def restore_tree(data):
    """``flax.serialization.msgpack_restore``: decode, then join chunked
    arrays."""
    return _unchunk_tree(unpackb(data))
