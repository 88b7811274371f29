"""The subset of HDF5 that fast5 files use, read and written in Python and
numpy.

The reader takes one ``read`` of the file and parses it in place:

- superblock versions 0-3; object headers of versions 1 and 2 with their
  continuation blocks (version 2's Jenkins lookup3 checksums verified);
- old-style groups (a symbol-table message, the group's version 1 B-tree,
  its symbol nodes and its local heap) and new-style groups, whose links
  are link messages in the header or, past 8 links, stored densely;
  members are listed in name order, as HDF5's ``H5Gget_objname_by_idx``
  lists them;
- dense link and attribute storage (HDF5 1.8's format): the messages in a
  fractal heap (managed objects in its direct and indirect blocks, tiny
  objects in the heap ID, huge objects through the heap's version 2
  B-tree), indexed by the lookup3 hash of their names in a version 2
  B-tree, which is walked to list them and searched to look one up;
- scalar and simple dataspaces; fixed-point numbers of either byte order
  and sign, IEEE float32 and float64, fixed-length strings (null-
  terminated, null- or space-padded), compounds of these (member encodings
  of versions 1-3), enumerations (as their integers; h5py's booleans as
  booleans) and variable-length strings (through the global heap);
- compact, contiguous and chunked data: a layout version 3 chunk index
  (a version 1 B-tree) and the layout version 4 single-chunk, implicit,
  fixed-array, extensible-array and version 2 B-tree indexes (HDF5 1.10's
  format); an undefined address yields the fill value;
- filter pipelines of versions 1 and 2 with deflate, shuffle, fletcher32
  (the checksum verified and stripped) and h5py's LZF (32000);
- attribute messages of versions 1-3, on groups and datasets.

Every checksum of the version 2 metadata is verified.  Datasets come back
as numpy arrays at the stored dtype and byte order, a copy out of the
file's bytes, with no per-element Python loop (except for variable-length
strings).  What the reader does not take raises a ``NotImplementedError``
that names it: a fractal heap with an I/O filter pipeline, virtual and
external storage, soft and external links, and every other filter
(filter 32020, VBZ, with the way to rewrite such files as gzip).  A file
that is not HDF5, or that is cut short, raises a ``ValueError`` that
names the object and the byte range at fault.

The writer writes the layout that h5py's default file format gives the
datasets of a synthetic fast5: superblock 0, version 1 object headers,
old-style groups, contiguous datasets of numbers, fixed-length strings and
compounds of them, and attributes (scalars or arrays of those types; a
``str`` is written as a fixed-length UTF-8 string).

API: ``open_file(path)`` returns the root ``Group``; a ``Group`` has
``members()``, ``group(path)``, ``dataset(path)`` and ``attrs``; a
``Dataset`` has ``read()``, ``attrs``, ``shape`` and ``dtype``;
``write_file(path, tree, attrs)`` writes a tree of dicts (groups) and
arrays (datasets).
"""

from __future__ import annotations

import math
import struct
import zlib
from collections.abc import Mapping
from typing import Optional

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"
VBZ_FILTER = 32020
LZF_FILTER = 32000  # h5py's own, registered when h5py is imported

# object header message types
_NIL, _DATASPACE, _LINK_INFO, _DATATYPE = 0x00, 0x01, 0x02, 0x03
_FILL_OLD, _FILL, _LINK, _EXTERNAL = 0x04, 0x05, 0x06, 0x07
_LAYOUT, _FILTERS, _ATTRIBUTE = 0x08, 0x0B, 0x0C
_CONTINUATION, _SYMBOL_TABLE, _ATTRIBUTE_INFO = 0x10, 0x11, 0x15

# (size, exponent location, exponent size, mantissa location, mantissa
# size, exponent bias) of the IEEE formats
_IEEE = {(4, 23, 8, 0, 23, 127), (8, 52, 11, 0, 52, 1023)}
_CLASS_NAMES = {2: "time", 4: "bitfield", 5: "opaque", 7: "reference",
                10: "array"}
_FILTER_NAMES = {4: "szip", 5: "nbit", 6: "scale-offset", 307: "bzip2",
                 32001: "blosc", 32004: "lz4", 32008: "bitshuffle",
                 32015: "zstd"}
_M32 = 0xFFFFFFFF


def _pad8(n: int) -> int:
    return (n + 7) & ~7


def _rot(x: int, k: int) -> int:
    return ((x << k) | (x >> (32 - k))) & _M32


def lookup3(data: bytes, initval: int = 0) -> int:
    """Bob Jenkins' lookup3 ``hashlittle``, the checksum of HDF5's version
    2 metadata (``H5_checksum_lookup3``)."""
    n = len(data)
    a = b = c = (0xDEADBEEF + n + initval) & _M32
    if n == 0:
        return c
    full = (n - 1) // 12  # blocks before the last one of 1-12 bytes
    words = struct.unpack_from(f"<{3 * full}I", data)
    for i in range(0, 3 * full, 3):
        a = (a + words[i]) & _M32
        b = (b + words[i + 1]) & _M32
        c = (c + words[i + 2]) & _M32
        a = ((a - c) & _M32) ^ _rot(c, 4)
        c = (c + b) & _M32
        b = ((b - a) & _M32) ^ _rot(a, 6)
        a = (a + c) & _M32
        c = ((c - b) & _M32) ^ _rot(b, 8)
        b = (b + a) & _M32
        a = ((a - c) & _M32) ^ _rot(c, 16)
        c = (c + b) & _M32
        b = ((b - a) & _M32) ^ _rot(a, 19)
        a = (a + c) & _M32
        c = ((c - b) & _M32) ^ _rot(b, 4)
        b = (b + a) & _M32
    tail = data[12 * full:]
    ta, tb, tc = struct.unpack("<3I", tail + bytes(12 - len(tail)))
    a, b, c = (a + ta) & _M32, (b + tb) & _M32, (c + tc) & _M32
    c = ((c ^ b) - _rot(b, 14)) & _M32
    a = ((a ^ c) - _rot(c, 11)) & _M32
    b = ((b ^ a) - _rot(a, 25)) & _M32
    c = ((c ^ b) - _rot(b, 16)) & _M32
    a = ((a ^ c) - _rot(c, 4)) & _M32
    b = ((b ^ a) - _rot(a, 14)) & _M32
    c = ((c ^ b) - _rot(b, 24)) & _M32
    return c


def _fletcher32_matches(body: bytes, stored: int) -> bool:
    """HDF5's fletcher32 of ``body`` (big-endian 16-bit words, an odd last
    byte as the high byte of a word) against ``stored``, modulo 65535 in
    each half, as the running sums are kept; also the byte-swapped form
    that old HDF5 versions wrote."""
    if len(body) % 2:
        body = bytes(body) + b"\0"
    w = np.frombuffer(body, ">u2").astype(np.int64)
    n = len(w)
    s1 = s2 = 0
    for lo in range(0, n, 1 << 20):  # keeps the int64 sums from overflowing
        part = w[lo:lo + (1 << 20)]
        weights = (n - lo - np.arange(len(part), dtype=np.int64)) % 65535
        s1 += int(part.sum())
        s2 += int((weights * part).sum())
    s1, s2 = s1 % 65535, s2 % 65535
    swapped = int.from_bytes(stored.to_bytes(4, "little"), "big")
    return any((v & 0xFFFF) % 65535 == s1 and (v >> 16) % 65535 == s2
               for v in (stored, swapped))


def _unshuffle(data: bytes, size: int) -> bytes:
    if size <= 1:
        return data
    n = len(data) // size
    body = np.frombuffer(data, np.uint8, n * size).reshape(size, n)
    return body.T.tobytes() + data[n * size:]


def _unlzf(data: bytes, what: str) -> bytes:
    """LZF's decompression (liblzf's ``lzf_decompress``, h5py's filter
    32000): a control byte below 32 starts a run of that many plus one
    literal bytes; any other holds a back-reference's length (its top 3
    bits plus 2, 7 meaning a length byte follows) and the high bits of its
    distance."""
    out = bytearray()
    i, n = 0, len(data)
    while i < n:
        ctrl = data[i]
        i += 1
        if ctrl < 32:
            if i + ctrl + 1 > n:
                raise ValueError(f"{what}: LZF: a literal run past the end")
            out += data[i:i + ctrl + 1]
            i += ctrl + 1
            continue
        length = ctrl >> 5
        if length == 7:
            length += data[i] if i < n else 0
            i += 1
        if i >= n:
            raise ValueError(f"{what}: LZF: a back-reference past the end")
        ref = len(out) - ((ctrl & 31) << 8) - data[i] - 1
        i += 1
        length += 2
        if ref < 0:
            raise ValueError(f"{what}: LZF: a back-reference before the start")
        period = len(out) - ref  # a reference may overlap what it writes
        piece = out[ref:ref + min(length, period)]
        out += (piece * -(-length // len(piece)))[:length]
    return bytes(out)


def _enc_size(n: int) -> int:
    """Bytes HDF5 takes to store counts up to ``n`` (``H5VM_limit_enc_size``:
    floor(log2 n) / 8 + 1)."""
    return (max(n, 1).bit_length() - 1) // 8 + 1


def _log2(n: int) -> int:
    return n.bit_length() - 1


def _le(cols: np.ndarray) -> np.ndarray:
    """Little-endian unsigned integers from the uint64 byte columns of
    ``cols`` (n x width)."""
    shifts = np.arange(cols.shape[1], dtype=np.uint64) * np.uint64(8)
    return (cols << shifts).sum(axis=1, dtype=np.uint64)


class _Type:
    """A decoded datatype: the numpy dtype of one stored element, and what
    a read must do beyond viewing the bytes ("vlen": a variable-length
    string, held as (size, collection address, index); "spacepad": a
    space-padded string, whose trailing spaces HDF5 turns into nulls)."""

    __slots__ = ("dtype", "special")

    def __init__(self, dtype: np.dtype, special: Optional[str] = None):
        self.dtype = dtype
        self.special = special


class _File:
    """One file's bytes and what has been parsed of them."""

    def __init__(self, buf: bytes, path: str):
        self.buf = buf
        self.view = memoryview(buf)  # slices of data without a copy
        self.path = path
        self.objects = {}      # header address -> Group or Dataset
        self.collections = {}  # global heap address -> {index: (start, size)}
        self._superblock()

    # ---- bytes

    def need(self, addr: Optional[int], size: int, what: str) -> None:
        if addr is None:
            raise ValueError(f"{self.path}: {what} has an undefined address")
        if addr < 0 or size < 0 or addr + size > len(self.buf):
            raise ValueError(
                f"{self.path}: {what} at bytes {addr}-{addr + size} lies "
                f"outside the file's {len(self.buf)} bytes (cut short?)")

    def signature(self, addr: int, sig: bytes, what: str) -> None:
        self.need(addr, len(sig), what)
        got = self.buf[addr:addr + len(sig)]
        if got != sig:
            raise ValueError(f"{self.path}: {what} at byte {addr} has the "
                             f"signature {got!r}, not {sig!r}")

    def checksum(self, start: int, end: int, what: str) -> None:
        self.need(start, end + 4 - start, what)
        stored, = struct.unpack_from("<I", self.buf, end)
        if lookup3(self.buf[start:end]) != stored:
            raise ValueError(f"{self.path}: {what} at bytes {start}-"
                             f"{end + 4}: checksum mismatch")

    def offset(self, p: int) -> Optional[int]:
        """The address stored at ``p``, made absolute; None if undefined."""
        v, = struct.unpack_from(self._o, self.buf, p)
        return None if v == self.undefined else self.base + v

    def length(self, p: int) -> int:
        return struct.unpack_from(self._l, self.buf, p)[0]

    # ---- superblock

    def _superblock(self) -> None:
        buf = self.buf
        at = 0
        while buf[at:at + 8] != SIGNATURE:
            at = 512 if at == 0 else 2 * at
            if at + 8 > len(buf):
                raise ValueError(f"{self.path}: not an HDF5 file (no "
                                 "superblock signature at byte 0, 512, "
                                 "1024, ...)")
        self.need(at, 12, "the superblock")
        version = buf[at + 8]
        if version in (0, 1):
            self.so, self.sl = buf[at + 13], buf[at + 14]
            p = at + 24 + (4 if version == 1 else 0)
            fields = 4 * self.so + 2 * self.so + 24  # + root symbol entry
        elif version in (2, 3):
            self.so, self.sl = buf[at + 9], buf[at + 10]
            p = at + 12
            fields = 4 * self.so
        else:
            raise NotImplementedError(f"{self.path}: HDF5 superblock "
                                      f"version {version}")
        if self.so not in (2, 4, 8) or self.sl not in (2, 4, 8):
            raise ValueError(f"{self.path}: the superblock gives offsets of "
                             f"{self.so} and lengths of {self.sl} bytes")
        self.need(at, p + fields - at, "the superblock")
        self._o = "<" + {2: "H", 4: "I", 8: "Q"}[self.so]
        self._l = "<" + {2: "H", 4: "I", 8: "Q"}[self.sl]
        self.undefined = (1 << (8 * self.so)) - 1
        self.base = at  # HDF5 takes the superblock's place as the base
        eof, = struct.unpack_from(self._o, buf, p + 2 * self.so)
        if version >= 2:
            self.checksum(at, p + fields, "the superblock")
            root = self.offset(p + 3 * self.so)
        else:
            root = self.offset(p + 5 * self.so)  # the root entry's header
        if at + eof > len(buf):
            raise ValueError(f"{self.path}: cut short: the superblock gives "
                             f"{at + eof} bytes, the file has {len(buf)}")
        if root is None:
            raise ValueError(f"{self.path}: the superblock has no root group")
        self.root_address = root

    # ---- object headers

    def messages(self, addr: int, what: str) -> list:
        """The messages of the object header at ``addr``, continuations
        followed, as (type, flags, data start, data size)."""
        self.need(addr, 6, what)
        if self.buf[addr:addr + 4] == b"OHDR":
            return self._messages_v2(addr, what)
        self.need(addr, 16, what)
        version = self.buf[addr]
        if version != 1:
            raise ValueError(f"{self.path}: {what} at byte {addr}: object "
                             f"header version {version}")
        size, = struct.unpack_from("<I", self.buf, addr + 8)
        chunks = [(addr + 16, size)]
        out = []
        for start, size in chunks:  # grows as continuations are found
            self.need(start, size, what)
            p, end = start, start + size
            while p + 8 <= end:
                mtype, msize, mflags = struct.unpack_from("<HHB", self.buf, p)
                p += 8
                if p + msize > end:
                    raise ValueError(f"{self.path}: {what}: a message at "
                                     f"byte {p} overruns its header block")
                if mtype == _CONTINUATION:
                    chunks.append((self.offset(p), self.length(p + self.so)))
                elif mtype != _NIL:
                    out.append((mtype, mflags, p, msize))
                p += msize
        return out

    def _messages_v2(self, addr: int, what: str) -> list:
        buf = self.buf
        flags = buf[addr + 5]
        p = addr + 6 + (16 if flags & 0x20 else 0) + (4 if flags & 0x10 else 0)
        width = 1 << (flags & 3)
        self.need(p, width, what)
        size = int.from_bytes(buf[p:p + width], "little")
        p += width
        head = 6 if flags & 0x04 else 4
        chunks = [(addr, p, p + size)]
        out = []
        for start, p, end in chunks:  # grows as continuations are found
            self.checksum(start, end, what)
            while p + head <= end:
                mtype, msize, mflags = struct.unpack_from("<BHB", buf, p)
                p += head
                if p + msize > end:
                    raise ValueError(f"{self.path}: {what}: a message at "
                                     f"byte {p} overruns its header block")
                if mtype == _CONTINUATION:
                    at, n = self.offset(p), self.length(p + self.so)
                    self.signature(at, b"OCHK", what + "'s continuation")
                    chunks.append((at, at + 4, at + n - 4))
                elif mtype != _NIL:
                    out.append((mtype, mflags, p, msize))
                p += msize
        return out

    def object(self, addr: int, name: str):
        obj = self.objects.get(addr)
        if obj is None:
            msgs = self.messages(addr, name)
            types = {m[0] for m in msgs}
            if _LAYOUT in types:
                obj = Dataset(self, addr, name, msgs)
            elif types & {_SYMBOL_TABLE, _LINK_INFO, _LINK}:
                obj = Group(self, addr, name, msgs)
            else:
                raise NotImplementedError(
                    f"{self.path}: {name} is neither a group nor a dataset "
                    "(a named datatype?)")
            self.objects[addr] = obj
        return obj

    # ---- datatypes and dataspaces

    def datatype(self, p: int, what: str) -> tuple:
        """(_Type, encoded length) of the datatype message at ``p``."""
        buf = self.buf
        self.need(p, 8, what)
        cls, version = buf[p] & 15, buf[p] >> 4
        bits = buf[p + 1] | buf[p + 2] << 8 | buf[p + 3] << 16
        size, = struct.unpack_from("<I", buf, p + 4)
        q = p + 8
        if cls == 0:
            offset, precision = struct.unpack_from("<HH", buf, q)
            if offset or precision != 8 * size or size not in (1, 2, 4, 8):
                raise NotImplementedError(
                    f"{self.path}: {what}: a {size}-byte fixed-point type of "
                    f"{precision} bits at bit {offset}")
            order = ">" if bits & 1 else "<"
            kind = "i" if bits & 8 else "u"
            return _Type(np.dtype(f"{order}{kind}{size}")), 12
        if cls == 1:
            layout = (size,) + struct.unpack_from("<BBBBI", buf, q + 4)
            if bits & 0x40 or layout not in _IEEE:
                raise NotImplementedError(
                    f"{self.path}: {what}: a {size}-byte floating-point type "
                    "that is not IEEE")
            order = ">" if bits & 1 else "<"
            return _Type(np.dtype(f"{order}f{size}")), 20
        if cls == 3:
            return _Type(np.dtype(f"S{size}"),
                         "spacepad" if bits & 15 == 2 else None), 8
        if cls == 6:
            return self._compound(p, version, bits & 0xFFFF, size, what)
        if cls == 8:
            return self._enum(q, version, bits & 0xFFFF, what)
        if cls == 9:
            if bits & 15 != 1:
                raise NotImplementedError(f"{self.path}: {what}: a variable-"
                                          "length sequence type")
            _, base_len = self.datatype(q, what)
            return _Type(np.dtype([("size", "<u4"), ("heap", self._o),
                                   ("index", "<u4")]), "vlen"), 8 + base_len
        raise NotImplementedError(f"{self.path}: {what}: the "
                                  f"{_CLASS_NAMES.get(cls, cls)} datatype "
                                  "class")

    def _compound(self, p: int, version: int, members: int, size: int,
                  what: str) -> tuple:
        buf = self.buf
        q = p + 8
        names, formats, offsets = [], [], []
        width = 1 if size < 1 << 8 else 2 if size < 1 << 16 else \
            3 if size < 1 << 24 else 4
        for _ in range(members):
            end = buf.index(b"\0", q)
            names.append(buf[q:end].decode())
            q = q + _pad8(end + 1 - q) if version < 3 else end + 1
            if version == 1:
                offset, dims = struct.unpack_from("<IB", buf, q)
                if dims:
                    raise NotImplementedError(f"{self.path}: {what}: an "
                                              "array member of a compound")
                q += 32
            elif version == 2:
                offset, = struct.unpack_from("<I", buf, q)
                q += 4
            else:
                offset = int.from_bytes(buf[q:q + width], "little")
                q += width
            member, n = self.datatype(q, what)
            if member.special == "vlen":
                raise NotImplementedError(f"{self.path}: {what}: a variable-"
                                          "length member of a compound")
            q += n
            formats.append(member.dtype)
            offsets.append(offset)
        return _Type(np.dtype({"names": names, "formats": formats,
                               "offsets": offsets, "itemsize": size})), q - p

    def _enum(self, q: int, version: int, members: int, what: str) -> tuple:
        """An enumeration reads as its base integer type; h5py's booleans
        (FALSE = 0, TRUE = 1 over a byte) as numpy booleans, as h5py gives
        them."""
        base, n = self.datatype(q, what)
        if base.special is not None or base.dtype.kind not in "iu":
            raise NotImplementedError(f"{self.path}: {what}: an enumeration "
                                      f"over {base.dtype}")
        p = q + n
        names = []
        for _ in range(members):
            end = self.buf.index(b"\0", p)
            names.append(self.buf[p:end])
            p = p + _pad8(end + 1 - p) if version < 3 else end + 1
        size = base.dtype.itemsize
        values = np.frombuffer(self.buf, base.dtype, members, p).tolist()
        p += members * size
        if size == 1 and names == [b"FALSE", b"TRUE"] and values == [0, 1]:
            return _Type(np.dtype("?")), p - q + 8
        return base, p - q + 8

    def dataspace(self, p: int, what: str) -> tuple:
        """(shape, max shape) of the dataspace message at ``p``; (None,
        None) for a null dataspace.  An unlimited maximum is None."""
        buf = self.buf
        version, rank, flags = buf[p], buf[p + 1], buf[p + 2]
        if version == 1:
            q = p + 8
        elif version == 2:
            if buf[p + 3] == 2:
                return None, None
            q = p + 4
        else:
            raise NotImplementedError(f"{self.path}: {what}: dataspace "
                                      f"message version {version}")
        fmt = f"<{rank}{self._l[1]}"
        self.need(q, (2 if flags & 1 else 1) * rank * self.sl, what)
        shape = struct.unpack_from(fmt, buf, q)
        if not flags & 1:
            return shape, shape
        top = (1 << (8 * self.sl)) - 1
        maxshape = tuple(None if m == top else m for m in
                         struct.unpack_from(fmt, buf, q + rank * self.sl))
        return shape, maxshape

    def values(self, raw: bytes, t: _Type, shape: tuple,
               as_str: bool) -> np.ndarray:
        """The array of ``shape`` stored in ``raw``, a copy; variable-length
        strings as objects, ``str`` with ``as_str`` (attributes, as h5py
        gives them) else ``bytes`` (datasets)."""
        n = math.prod(shape)
        if len(raw) < n * t.dtype.itemsize:
            raise ValueError(f"{self.path}: {len(raw)} bytes hold no "
                             f"{n} elements of {t.dtype}")
        arr = np.frombuffer(raw, t.dtype, n).copy()
        if t.special == "vlen":
            out = np.empty(n, dtype=object)
            for i, (size, heap, index) in enumerate(arr.tolist()):
                s = self._heap_object(heap, index)[:size] if size else b""
                out[i] = s.decode("utf-8") if as_str else s
            arr = out
        elif t.special == "spacepad":
            arr = np.char.rstrip(arr, b" ")
        return arr.reshape(shape)

    def _heap_object(self, heap: int, index: int) -> bytes:
        addr = self.base + heap
        objects = self.collections.get(addr)
        if objects is None:
            what = "a global heap collection"
            self.signature(addr, b"GCOL", what)
            size = self.length(addr + 8)
            self.need(addr, size, what)
            objects = {}
            p, end = addr + 8 + self.sl, addr + size
            while p + 8 + self.sl <= end:
                i, = struct.unpack_from("<H", self.buf, p)
                n = self.length(p + 8)
                if i == 0:  # the free space closes the collection
                    break
                objects[i] = (p + 8 + self.sl, n)
                p += 8 + self.sl + _pad8(n)
            self.collections[addr] = objects
        if index not in objects:
            raise ValueError(f"{self.path}: no object {index} in the global "
                             f"heap collection at byte {addr}")
        start, n = objects[index]
        self.need(start, n, "a global heap object")
        return self.buf[start:start + n]

    def version0(self, addr: int, sig: bytes, what: str) -> None:
        """The signature ``sig`` and version 0 at ``addr``."""
        self.signature(addr, sig, what)
        self.need(addr, 5, what)
        if self.buf[addr + 4] != 0:
            raise NotImplementedError(f"{self.path}: {what} at byte {addr}: "
                                      f"version {self.buf[addr + 4]}")


class _BTree2:
    """A version 2 B-tree (``BTHD``; nodes ``BTIN`` and ``BTLF``, each
    checksummed): the file positions of its records, all of them or those
    of one key."""

    def __init__(self, f: _File, addr: int, what: str):
        self.f, self.what = f, what
        f.version0(addr, b"BTHD", what)
        f.need(addr, 22 + f.so + f.sl, what)
        self.type = f.buf[addr + 5]
        node_size, self.rec_size, self.depth = struct.unpack_from(
            "<IHH", f.buf, addr + 6)
        self.root = f.offset(addr + 16)
        self.nroot, = struct.unpack_from("<H", f.buf, addr + 16 + f.so)
        f.checksum(addr, addr + 18 + f.so + f.sl, what)
        # An internal node at depth d points to each child with its address,
        # its record count (a width for the most records a leaf holds) and,
        # below depth 1, the records under it (a width for the most a child
        # at depth d - 1 holds): H5B2__hdr_init's node_info table.
        most = (node_size - 10) // self.rec_size  # 10: signature to checksum
        self.count_width = _enc_size(most)
        self.total_width = [0]
        for _ in range(self.depth):
            pointer = f.so + self.count_width + self.total_width[-1]
            n = (node_size - 10 - pointer) // (self.rec_size + pointer)
            most = (n + 1) * most + n
            self.total_width.append(_enc_size(most))

    def records(self, key=None, match=None) -> list:
        """Positions of the records in the tree's order; with ``key`` (a
        function of a record's position), only those whose key is
        ``match``, descending only into the nodes that can hold one (two
        records may share a key)."""
        out = []
        if self.root is not None and self.nroot:
            self._node(self.root, self.nroot, self.depth, key, match, out)
        return out

    def _node(self, addr: int, nrec: int, depth: int, key, match,
              out: list) -> None:
        f, buf = self.f, self.f.buf
        what = f"{self.what}'s node"
        f.version0(addr, b"BTIN" if depth else b"BTLF", what)
        recs = [addr + 6 + i * self.rec_size for i in range(nrec)]
        p = addr + 6 + nrec * self.rec_size
        children = []
        if depth:
            width = self.count_width
            pointer = f.so + width + self.total_width[depth - 1]
            f.need(p, (nrec + 1) * pointer, what)
            for q in range(p, p + (nrec + 1) * pointer, pointer):
                children.append((f.offset(q), int.from_bytes(
                    buf[q + f.so:q + f.so + width], "little")))
            p += (nrec + 1) * pointer
        f.checksum(addr, p, what)
        if buf[addr + 5] != self.type:
            raise ValueError(f"{f.path}: {what} at byte {addr}: record type "
                             f"{buf[addr + 5]}, not {self.type}")
        keys = [key(r) for r in recs] if key else None
        for i in range(nrec + 1):
            if depth and (key is None or (
                    (i == 0 or keys[i - 1] <= match) and
                    (i == nrec or keys[i] >= match))):
                child, n = children[i]
                if child is None:
                    raise ValueError(f"{f.path}: {what} at byte {addr}: a "
                                     "child with an undefined address")
                self._node(child, n, depth - 1, key, match, out)
            if i < nrec and (key is None or keys[i] == match):
                out.append(recs[i])


class _Heap:
    """A fractal heap (``FRHP``) without an I/O filter pipeline: where each
    object lies in the file.  Managed objects lie in direct blocks
    (``FHDB``), found through the doubling table of indirect blocks
    (``FHIB``); tiny objects in the heap ID itself; huge objects outside
    the heap, found through the heap's version 2 B-tree unless the heap ID
    holds their address."""

    def __init__(self, f: _File, addr: int, what: str):
        self.f, self.what = f, what
        buf, so, sl = f.buf, f.so, f.sl
        f.version0(addr, b"FRHP", what)
        p = addr + 14 + 10 * sl + 2 * so  # the doubling table
        f.need(addr, p + 12 + 2 * sl + so - addr, what)
        self.id_len, filters = struct.unpack_from("<HH", buf, addr + 5)
        # a filtered heap adds its root block's size, a mask and the pipeline
        f.checksum(addr, p + 8 + 2 * sl + so + (
            sl + 4 + filters if filters else 0), what)
        if filters:
            raise NotImplementedError(f"{f.path}: {what}: a fractal heap "
                                      "with an I/O filter pipeline")
        self.checked = bool(buf[addr + 9] & 2)  # direct blocks checksummed
        max_managed, = struct.unpack_from("<I", buf, addr + 10)
        self.huge_tree = f.offset(addr + 14 + sl)
        self.width, = struct.unpack_from("<H", buf, p)
        self.start, max_direct = f.length(p + 2), f.length(p + 2 + sl)
        heap_bits, = struct.unpack_from("<H", buf, p + 2 + 2 * sl)
        self.root = f.offset(p + 6 + 2 * sl)
        self.root_rows, = struct.unpack_from("<H", buf, p + 6 + 2 * sl + so)
        for name, v in (("table width", self.width),
                        ("starting block size", self.start),
                        ("largest direct block", max_direct)):
            if v < 1 or v & (v - 1):
                raise ValueError(f"{f.path}: {what}: a {name} of {v}")
        self.first_row_bits = _log2(self.start) + _log2(self.width)
        self.direct_rows = _log2(max_direct) - _log2(self.start) + 2
        self.off_size = (heap_bits + 7) // 8
        self.len_size = min((_log2(max_direct) + 7) // 8,
                            _enc_size(max_managed))
        self.prefix = 5 + so + self.off_size + (4 if self.checked else 0)
        self.blocks = {}  # address -> children (indirect) or True (direct)

    def object(self, p: int) -> tuple:
        """(position, size) in the file of the object whose heap ID is at
        ``p``."""
        f, buf = self.f, self.f.buf
        what = f"{self.what}'s heap ID"
        f.need(p, self.id_len, what)
        kind = buf[p] >> 4
        if kind == 0:  # managed
            q = p + 1 + self.off_size
            offset = int.from_bytes(buf[p + 1:q], "little")
            size = int.from_bytes(buf[q:q + self.len_size], "little")
            return self._managed(offset, size), size
        if kind == 2:  # tiny
            if self.id_len - 1 <= 16:
                return p + 1, (buf[p] & 15) + 1
            return p + 2, ((buf[p] & 15) << 8 | buf[p + 1]) + 1
        if kind == 1:  # huge
            if f.so + f.sl <= self.id_len - 1:
                at, size = f.offset(p + 1), f.length(p + 1 + f.so)
            else:
                key = int.from_bytes(buf[p + 1:p + min(self.id_len, 9)],
                                     "little")
                at, size = self._huge(key)
            f.need(at, size, f"{self.what}'s huge object")
            return at, size
        raise ValueError(f"{f.path}: {what} at byte {p}: version and type "
                         f"byte {buf[p]:#04x}")

    def _huge(self, key: int) -> tuple:
        f = self.f
        if self.huge_tree is None:
            raise ValueError(f"{f.path}: {self.what}: a huge object but no "
                             "B-tree of huge objects")
        tree = _BTree2(f, self.huge_tree, f"{self.what}'s huge objects")
        if tree.type != 1:
            raise NotImplementedError(
                f"{f.path}: {self.what}: huge objects indexed by records of "
                f"type {tree.type}")
        found = tree.records(lambda r: f.length(r + f.so + f.sl), key)
        if len(found) != 1:
            raise ValueError(f"{f.path}: {self.what}: {len(found)} huge "
                             f"objects of ID {key}")
        return f.offset(found[0]), f.length(found[0] + f.so)

    def _managed(self, offset: int, size: int) -> int:
        """The file position of the managed object at ``offset``: down the
        doubling table (rows 0 and 1 of blocks of the starting size, each
        later row twice the one before; rows past ``direct_rows`` hold
        indirect blocks) to its direct block."""
        f = self.f
        addr, rows, base, block = self.root, self.root_rows, 0, self.start
        while rows:
            children = self._indirect(addr, rows, base)
            rel = offset - base
            if rel < self.start * self.width:
                row, col = 0, rel // self.start
            else:
                row = _log2(rel) - self.first_row_bits + 1
                col = (rel - (1 << _log2(rel))) // (self.start << (row - 1))
            block = self.start << max(row - 1, 0)
            if row >= rows:
                raise ValueError(f"{f.path}: {self.what}: offset {offset} "
                                 "lies past the heap's blocks")
            addr = children[row * self.width + col]
            base += (0 if row == 0 else (self.start * self.width) << (row - 1)
                     ) + col * block
            if row < self.direct_rows:
                break
            rows = _log2(block) - self.first_row_bits + 1
        if addr is None:
            raise ValueError(f"{f.path}: {self.what}: offset {offset} lies in "
                             "a block that was never written")
        self._direct(addr, base, block)
        at = addr + offset - base
        if offset - base < self.prefix or offset - base + size > block:
            raise ValueError(f"{f.path}: {self.what}: an object of {size} "
                             f"bytes at offset {offset} overruns its block")
        return at

    def _indirect(self, addr: int, rows: int, base: int) -> list:
        children = self.blocks.get(addr)
        if children is None:
            f = self.f
            what = f"{self.what}'s indirect block"
            f.version0(addr, b"FHIB", what)
            p = addr + 5 + f.so + self.off_size
            n = rows * self.width
            f.need(p, n * f.so, what)
            children = [f.offset(q) for q in range(p, p + n * f.so, f.so)]
            f.checksum(addr, p + n * f.so, what)
            self._offset_is(addr + 5 + f.so, base, what)
            self.blocks[addr] = children
        return children

    def _direct(self, addr: int, base: int, size: int) -> None:
        if addr in self.blocks:
            return
        f = self.f
        what = f"{self.what}'s direct block"
        f.version0(addr, b"FHDB", what)
        f.need(addr, size, what)
        self._offset_is(addr + 5 + f.so, base, what)
        if self.checked:
            at = addr + self.prefix - 4
            stored, = struct.unpack_from("<I", f.buf, at)
            if lookup3(f.buf[addr:at] + bytes(4) +
                       f.buf[at + 4:addr + size]) != stored:
                raise ValueError(f"{f.path}: {what} at bytes {addr}-"
                                 f"{addr + size}: checksum mismatch")
        self.blocks[addr] = True

    def _offset_is(self, p: int, base: int, what: str) -> None:
        got = int.from_bytes(self.f.buf[p:p + self.off_size], "little")
        if got != base:
            raise ValueError(f"{self.f.path}: {what} at byte {p}: the block "
                             f"offset {got}, not {base}")


class _Dense:
    """Links or attributes stored densely: messages in a fractal heap,
    indexed by the lookup3 hash of their names in a version 2 B-tree
    (records of type 5: hash, heap ID; of type 8: heap ID, message flags,
    creation order, hash).  ``p`` is the position of the heap's address
    in the link- or attribute-info message, the name index's follows it.
    A creation-order index, where there is one, is not read: listing and
    lookup go through the name index, which is always there."""

    def __init__(self, f: _File, p: int, kind: int, what: str):
        self.f = f
        self.heap = _Heap(f, f.offset(p), what + "'s fractal heap")
        self.tree = _BTree2(f, f.offset(p + f.so), what + "'s name index")
        if self.tree.type != kind:
            raise ValueError(f"{f.path}: {what}'s name index holds records "
                             f"of type {self.tree.type}, not {kind}")
        self.hash_at, self.id_at = (0, 4) if kind == 5 else (13, 0)

    def messages(self, name: Optional[str] = None) -> list:
        """(position, size) of each stored message, or of those whose name
        hashes as ``name`` does."""
        if name is None:
            found = self.tree.records()
        else:
            buf, at = self.f.buf, self.hash_at
            found = self.tree.records(
                lambda r: struct.unpack_from("<I", buf, r + at)[0],
                lookup3(name.encode("utf-8")))
        return [self.heap.object(r + self.id_at) for r in found]


class Attributes(Mapping):
    """An object's attributes by name, each decoded when it is read: a
    numpy scalar for a scalar dataspace (a ``str`` for a variable-length
    string), an array otherwise, None for a null dataspace."""

    def __init__(self, obj):
        self._file = obj._file
        self._name = obj.name
        self._where = {}
        self._dense = None  # a _Dense until all its names are listed
        for mtype, _flags, p, _size in obj._msgs:
            if mtype == _ATTRIBUTE_INFO:
                q = p + 2 + (2 if self._file.buf[p + 1] & 1 else 0)
                if self._file.offset(q) is not None:
                    self._dense = _Dense(self._file, q, 8,
                                         f"{obj.name}'s attribute storage")
            elif mtype == _ATTRIBUTE:
                name, parts = self._parse(p)
                self._where[name] = parts

    def _list(self, name: Optional[str] = None) -> None:
        """Parse the densely stored attribute messages, or those whose
        name hashes as ``name`` does, into ``_where``; when all are listed,
        in name order."""
        for p, size in self._dense.messages(name):
            self._file.need(p, size, f"{self._name}'s attribute message")
            found, parts = self._parse(p)
            self._where[found] = parts
        if name is None:
            self._where = dict(sorted(self._where.items(),
                                      key=lambda kv: kv[0].encode()))
            self._dense = None

    def _parse(self, p: int) -> tuple:
        buf = self._file.buf
        version = buf[p]
        nlen, tlen, slen = struct.unpack_from("<HHH", buf, p + 2)
        if version == 1:
            q = p + 8
            pad = _pad8
        elif version in (2, 3):
            if buf[p + 1] & 3:
                raise NotImplementedError(f"{self._file.path}: {self._name}:"
                                          " an attribute of a shared type")
            q = p + 8 + (1 if version == 3 else 0)

            def pad(n):
                return n
        else:
            raise NotImplementedError(f"{self._file.path}: {self._name}: "
                                      f"attribute message version {version}")
        name = buf[q:q + nlen].split(b"\0", 1)[0].decode("utf-8")
        tp = q + pad(nlen)
        sp = tp + pad(tlen)
        return name, (tp, sp, sp + pad(slen))

    def __getitem__(self, name: str):
        if name not in self._where and self._dense is not None:
            self._list(name)
        if name not in self._where:
            raise KeyError(f"no attribute {name!r} on {self._name}")
        f = self._file
        tp, sp, dp = self._where[name]
        what = f"{self._name}'s attribute {name!r}"
        t, _ = f.datatype(tp, what)
        shape, _ = f.dataspace(sp, what)
        if shape is None:
            return None
        n = math.prod(shape) * t.dtype.itemsize
        f.need(dp, n, what)
        if shape == () and t.special is None:
            return np.frombuffer(f.buf, t.dtype, 1, dp)[0]
        arr = f.values(f.buf[dp:dp + n], t, shape, as_str=True)
        return arr[()] if shape == () else arr

    def __iter__(self):
        if self._dense is not None:
            self._list()
        return iter(self._where)

    def __len__(self) -> int:
        if self._dense is not None:
            self._list()
        return len(self._where)


class _Object:
    def __init__(self, file: _File, addr: int, name: str, msgs: list):
        self._file = file
        self._addr = addr
        self._msgs = msgs
        self.name = name
        self._attrs = None

    @property
    def attrs(self) -> Attributes:
        if self._attrs is None:
            self._attrs = Attributes(self)
        return self._attrs

    def __repr__(self) -> str:
        return f"<{type(self).__name__} {self.name} of {self._file.path}>"


class Group(_Object):
    """An HDF5 group."""

    _links = None
    _dense = False  # the group's dense link storage once looked for

    def _members(self) -> dict:
        """Name -> object header address, in name order."""
        if self._links is None:
            table = [m for m in self._msgs if m[0] == _SYMBOL_TABLE]
            if table:
                links = self._symbol_table(table[0][2])
            else:
                dense = self._dense_links()
                links = dict(self._link(p, n) for p, n in
                             (dense.messages() if dense else []))
                links.update(self._link(p, n) for t, _f, p, n in self._msgs
                             if t == _LINK)
            self._links = dict(sorted(links.items(),
                                      key=lambda kv: kv[0].encode()))
        return self._links

    def _member(self, name: str):
        """The target of the link ``name``, None if there is none; looked
        up by its hash where the links are stored densely."""
        dense = self._dense_links() if self._links is None else None
        if dense is None:
            return self._members().get(name)
        for p, n in dense.messages(name):
            found, target = self._link(p, n)
            if found == name:
                return target
        return None

    def _dense_links(self) -> Optional[_Dense]:
        if self._dense is False:
            self._dense = None
            f = self._file
            for mtype, _flags, p, _size in self._msgs:
                if mtype == _LINK_INFO:
                    q = p + 2 + (8 if f.buf[p + 1] & 1 else 0)
                    if f.offset(q) is not None:
                        self._dense = _Dense(f, q, 5,
                                             f"{self.name}'s link storage")
        return self._dense

    def _link(self, p: int, size: int) -> tuple:
        """(name, target) of the link message of ``size`` bytes at ``p``:
        the target a header address, or "soft" or "external"."""
        f, buf = self._file, self._file.buf
        f.need(p, size, f"{self.name}'s link message")
        flags = buf[p + 1]
        q = p + 2
        kind = 0
        if flags & 0x08:
            kind = buf[q]
            q += 1
        q += (8 if flags & 0x04 else 0) + (1 if flags & 0x10 else 0)
        width = 1 << (flags & 3)
        n = int.from_bytes(buf[q:q + width], "little")
        name = buf[q + width:q + width + n].decode("utf-8")
        return name, f.offset(q + width + n) if kind == 0 else \
            ("soft" if kind == 1 else "external")

    def _symbol_table(self, p: int) -> dict:
        """The members of an old-style group: the leaves of its version 1
        B-tree are symbol nodes whose names live in its local heap."""
        f, buf = self._file, self._file.buf
        tree, heap = f.offset(p), f.offset(p + f.so)
        what = f"{self.name}'s local heap"
        f.signature(heap, b"HEAP", what)
        size = f.length(heap + 8)
        data = f.offset(heap + 8 + 2 * f.sl)
        f.need(data, size, what)
        entry = 2 * f.so + 24
        links = {}
        nodes = [tree]
        while nodes:
            node = nodes.pop()
            what = f"{self.name}'s B-tree node"
            f.signature(node, b"TREE", what)
            level, used = buf[node + 5], struct.unpack_from(
                "<H", buf, node + 6)[0]
            q = node + 8 + 2 * f.so + f.sl  # the first child
            f.need(q, used * (f.so + f.sl), what)
            children = [f.offset(q + i * (f.so + f.sl)) for i in range(used)]
            if level:
                nodes.extend(reversed(children))
                continue
            for snod in children:
                f.signature(snod, b"SNOD", f"{self.name}'s symbol node")
                count, = struct.unpack_from("<H", buf, snod + 6)
                f.need(snod + 8, count * entry, f"{self.name}'s symbol node")
                for e in range(snod + 8, snod + 8 + count * entry, entry):
                    at = data + struct.unpack_from(f._o, buf, e)[0]
                    name = buf[at:buf.index(b"\0", at)].decode("utf-8")
                    cache, = struct.unpack_from("<I", buf, e + 2 * f.so)
                    links[name] = "soft" if cache == 2 else f.offset(e + f.so)
        return links

    def members(self) -> list:
        """Member names in name order (``H5Gget_objname_by_idx``'s)."""
        return list(self._members())

    def _get(self, path: str):
        obj = self
        for part in path.strip("/").split("/"):
            if not isinstance(obj, Group):
                raise KeyError(f"{obj.name} is a dataset, not a group")
            target = obj._member(part)
            if target is None:
                raise KeyError(f"no member {part!r} in {obj.name}")
            name = f"{obj.name.rstrip('/')}/{part}"
            if isinstance(target, str):
                raise NotImplementedError(f"{self._file.path}: {name} is a "
                                          f"{target} link")
            obj = self._file.object(target, name)
        return obj

    def group(self, path: str) -> "Group":
        obj = self._get(path)
        if not isinstance(obj, Group):
            raise KeyError(f"{obj.name} is a dataset, not a group")
        return obj

    def dataset(self, path: str) -> "Dataset":
        obj = self._get(path)
        if not isinstance(obj, Dataset):
            raise KeyError(f"{obj.name} is a group, not a dataset")
        return obj


class Dataset(_Object):
    """An HDF5 dataset."""

    def __init__(self, file: _File, addr: int, name: str, msgs: list):
        super().__init__(file, addr, name, msgs)
        self._filters = []
        self._fill = None
        types = {m[0] for m in msgs}
        if not {_DATASPACE, _DATATYPE} <= types:
            raise ValueError(f"{file.path}: {name} has a data layout but no "
                             "dataspace or no datatype message")
        for mtype, _flags, p, size in msgs:
            if mtype == _DATASPACE:
                self.shape, self._maxshape = file.dataspace(p, name)
            elif mtype == _DATATYPE:
                if _flags & 2:  # the message is shared
                    raise NotImplementedError(f"{file.path}: {name}: a "
                                              "shared (committed) datatype")
                self._type, _ = file.datatype(p, name)
            elif mtype == _LAYOUT:
                self._layout(p)
            elif mtype == _FILTERS:
                self._pipeline(p)
            elif mtype in (_FILL, _FILL_OLD):
                self._fill_value(mtype, p, size)
            elif mtype == _EXTERNAL:
                raise NotImplementedError(f"{file.path}: {name}: external "
                                          "storage")
        if self.shape is None:
            raise NotImplementedError(f"{file.path}: {name}: a null "
                                      "dataspace")
        self.dtype = self._type.dtype

    shape = None

    def _layout(self, p: int) -> None:
        f, buf = self._file, self._file.buf
        version = buf[p]
        self._chunk = None
        if version not in (3, 4):
            raise NotImplementedError(f"{f.path}: {self.name}: data layout "
                                      f"message version {version}")
        cls = buf[p + 1]
        q = p + 2
        if cls == 0:
            self._compact = (q + 2, struct.unpack_from("<H", buf, q)[0])
        elif cls == 1:
            self._addr_data = f.offset(q)
        elif cls == 2 and version == 3:
            rank = buf[q]
            self._addr_data = f.offset(q + 1)
            self._chunk = struct.unpack_from(f"<{rank}I", buf,
                                             q + 1 + f.so)[:-1]
            self._index = "btree"
        elif cls == 2:
            self._chunked_v4(q)
        else:
            raise NotImplementedError(f"{f.path}: {self.name}: virtual "
                                      "storage")

    def _chunked_v4(self, q: int) -> None:
        f, buf = self._file, self._file.buf
        flags, rank, width = buf[q], buf[q + 1], buf[q + 2]
        q += 3
        dims = [int.from_bytes(buf[q + i * width:q + (i + 1) * width],
                               "little") for i in range(rank)]
        q += rank * width
        self._chunk = tuple(dims[:-1])
        self._edge_unfiltered = bool(flags & 1)
        index = buf[q]
        q += 1
        if index == 1:
            self._index = "single"
            self._single = (None, 0)
            if flags & 2:
                self._single = (f.length(q), struct.unpack_from(
                    "<I", buf, q + f.sl)[0])
                q += f.sl + 4
        elif index == 2:
            self._index = "implicit"
        elif index in (3, 4, 5):  # their parameters: 1, 5 and 6 bytes
            self._index = {3: "farray", 4: "earray", 5: "btree2"}[index]
            q += {3: 1, 4: 5, 5: 6}[index]
        else:
            raise NotImplementedError(f"{f.path}: {self.name}: chunk index "
                                      f"type {index}")
        self._addr_data = f.offset(q)

    _addr_data = None
    _compact = None
    _edge_unfiltered = False

    def _pipeline(self, p: int) -> None:
        buf = self._file.buf
        version, count = buf[p], buf[p + 1]
        q = p + (8 if version == 1 else 2)
        for _ in range(count):
            fid, = struct.unpack_from("<H", buf, q)
            if version == 1 or fid >= 256:
                nlen, flags, nvalues = struct.unpack_from("<HHH", buf, q + 2)
                q += 8
            else:
                nlen = 0
                flags, nvalues = struct.unpack_from("<HH", buf, q + 2)
                q += 6
            name = buf[q:q + nlen].split(b"\0", 1)[0].decode("latin-1")
            q += _pad8(nlen) if version == 1 else nlen
            values = struct.unpack_from(f"<{nvalues}I", buf, q)
            q += 4 * nvalues + (4 if version == 1 and nvalues % 2 else 0)
            self._filters.append((fid, name, values))

    def _fill_value(self, mtype: int, p: int, size: int) -> None:
        buf = self._file.buf
        if mtype == _FILL_OLD:
            n, q = struct.unpack_from("<I", buf, p)[0], p + 4
        elif buf[p] in (1, 2):
            if buf[p + 3] == 0 or size < 8:
                return
            n, q = struct.unpack_from("<I", buf, p + 4)[0], p + 8
        else:
            if not buf[p + 1] & 0x20:
                return
            n, q = struct.unpack_from("<I", buf, p + 2)[0], p + 6
        if n:
            self._fill = buf[q:q + n]

    # ---- reading

    def read(self) -> np.ndarray:
        """The whole dataset, at the stored dtype and byte order."""
        f = self._file
        n = math.prod(self.shape)
        nbytes = n * self.dtype.itemsize
        if self._compact is not None:
            start, size = self._compact
            f.need(start, size, self.name)
            raw = f.view[start:start + size]
        elif self._chunk is not None:
            raw = self._read_chunks(n)
        elif self._addr_data is None or nbytes == 0:
            raw = self._filled(n)
        else:
            f.need(self._addr_data, nbytes, f"{self.name}'s data")
            raw = f.view[self._addr_data:self._addr_data + nbytes]
        return f.values(raw, self._type, self.shape, as_str=False)

    def _filled(self, n: int) -> bytes:
        if self._fill is None or self._type.special == "vlen":
            return bytes(n * self.dtype.itemsize)
        return self._fill * n

    def _read_chunks(self, n: int) -> bytes:
        shape, chunk = self.shape, self._chunk
        out = np.frombuffer(bytearray(self._filled(n)), self.dtype)
        out = out.reshape(shape)
        per_chunk = math.prod(chunk)
        nbytes = per_chunk * self.dtype.itemsize
        for offsets, addr, size, mask in self._chunks(nbytes):
            what = f"{self.name}'s chunk at {offsets}"
            if addr is None:
                continue
            self._file.need(addr, size, what)
            data = self._file.view[addr:addr + size]
            partial = any(o + c > s for o, c, s in zip(offsets, chunk, shape))
            if not (partial and self._edge_unfiltered):
                data = self._unfilter(data, mask, what)
            if len(data) < nbytes:
                raise ValueError(f"{self._file.path}: {what}: {len(data)} "
                                 f"bytes, not {nbytes}")
            block = np.frombuffer(data, self.dtype, per_chunk).reshape(chunk)
            region = tuple(slice(o, min(o + c, s))
                           for o, c, s in zip(offsets, chunk, shape))
            out[region] = block[tuple(slice(0, r.stop - r.start)
                                      for r in region)]
        return out.tobytes()

    def _chunks(self, nbytes: int):
        """(offsets, address, stored size, filter mask) of every stored
        chunk."""
        if self._index == "btree":
            yield from self._btree_chunks()
            return
        if self._index == "single":
            size, mask = self._single
            yield (0,) * len(self.shape), self._addr_data, \
                nbytes if size is None else size, mask
            return
        if self._addr_data is None:
            return
        if self._index == "btree2":
            yield from self._btree2_chunks(nbytes)
            return
        grid = [-(-s // c) for s, c in zip(self.shape, self._chunk)]
        maxgrid = [-(-(m if m is not None else s) // c) for m, s, c in
                   zip(self._maxshape, self.shape, self._chunk)]
        if self._index == "implicit":
            scaled = np.indices(grid).reshape(len(grid), -1).T
            down = np.cumprod([1] + maxgrid[:0:-1])[::-1]
            addr = self._addr_data + (scaled @ down) * nbytes
            size, mask = np.full(len(addr), nbytes), np.zeros(len(addr), int)
        else:
            idx, addr, size, mask = self._farray_entries() \
                if self._index == "farray" else self._earray_entries()
            scaled = self._scaled(idx, maxgrid)
            keep = (scaled < grid).all(axis=1)
            scaled, addr, mask = scaled[keep], addr[keep], mask[keep]
            size = np.full(len(addr), nbytes) if size is None else size[keep]
        for s, a, n, m in zip(scaled.tolist(), addr.tolist(), size.tolist(),
                              mask.tolist()):
            yield tuple(i * c for i, c in zip(s, self._chunk)), a, n, m

    def _scaled(self, idx: np.ndarray, maxgrid: list) -> np.ndarray:
        """The chunk-grid coordinates of linear chunk indices: row-major over
        the largest grid the dataset can reach, an extensible array's
        unlimited dimension moved first (``H5VM_swizzle_coords``)."""
        order = list(range(len(maxgrid)))
        dims = list(maxgrid)
        if self._index == "earray":
            unlimited = self._maxshape.index(None)
            order.insert(0, order.pop(unlimited))
            dims = [maxgrid[d] for d in order]
            dims[0] = int(idx.max(initial=0)) // math.prod(dims[1:]) + 1
        coords = np.unravel_index(idx, dims)
        out = np.empty((len(idx), len(order)), np.int64)
        for k, d in enumerate(order):
            out[:, d] = coords[k]
        return out

    def _btree_chunks(self):
        f, buf = self._file, self._file.buf
        rank = len(self._chunk) + 1
        key = 8 + 8 * rank
        nodes = [self._addr_data] if self._addr_data is not None else []
        while nodes:
            node = nodes.pop()
            what = f"{self.name}'s chunk B-tree node"
            f.signature(node, b"TREE", what)
            level, used = buf[node + 5], struct.unpack_from(
                "<H", buf, node + 6)[0]
            q = node + 8 + 2 * f.so
            f.need(q, used * (key + f.so) + key, what)
            for _ in range(used):
                size, mask = struct.unpack_from("<II", buf, q)
                offsets = struct.unpack_from(f"<{rank - 1}Q", buf, q + 8)
                child = f.offset(q + key)
                q += key + f.so
                if level:
                    nodes.append(child)
                else:
                    yield offsets, child, size, mask

    def _btree2_chunks(self, nbytes: int):
        """The chunks of a version 2 B-tree chunk index: records of type 10
        (address, scaled offsets) or 11 (address, stored size, filter mask,
        scaled offsets)."""
        f, buf = self._file, self._file.buf
        tree = _BTree2(f, self._addr_data, f"{self.name}'s chunk B-tree")
        rank = len(self._chunk)
        if tree.type not in (10, 11):
            raise ValueError(f"{f.path}: {self.name}'s chunk B-tree holds "
                             f"records of type {tree.type}")
        width = tree.rec_size - f.so - 4 - 8 * rank  # the stored size's
        for r in tree.records():
            q = r + f.so
            size, mask = nbytes, 0
            if tree.type == 11:
                size = int.from_bytes(buf[q:q + width], "little")
                mask, = struct.unpack_from("<I", buf, q + width)
                q += width + 4
            scaled = struct.unpack_from(f"<{rank}Q", buf, q)
            yield tuple(s * c for s, c in zip(scaled, self._chunk)), \
                f.offset(r), size, mask

    def _entries(self, spans: list, esize: int, filtered: bool,
                 what: str) -> tuple:
        """(linear index, address, stored size or None, filter mask) arrays
        of the defined chunk entries of an array index, from spans of
        (first linear index, position of the entries, count): an entry is
        the chunk's address and, for filtered chunks, its stored size and
        filter mask."""
        f = self._file
        so = f.so
        parts = []
        for start, pos, n in spans:
            f.need(pos, n * esize, what)
            raw = np.frombuffer(f.buf, np.uint8, n * esize, pos).reshape(
                n, esize).astype(np.uint64)
            addr = _le(raw[:, :so])
            keep = np.flatnonzero(addr != f.undefined)
            size = mask = np.zeros(len(keep), np.uint64)
            if filtered:
                width = esize - so - 4
                size = _le(raw[keep, so:so + width])
                mask = _le(raw[keep, so + width:])
            parts.append((start + keep, addr[keep] + np.uint64(f.base), size,
                          mask))
        if not parts:
            parts = [(np.zeros(0, np.int64),) + (np.zeros(0, np.uint64),) * 3]
        idx, addr, size, mask = (np.concatenate(x) for x in zip(*parts))
        return (idx, addr.astype(np.int64),
                size.astype(np.int64) if filtered else None,
                mask.astype(np.int64))

    def _farray_entries(self) -> tuple:
        """The entries (``_entries``) of a fixed-array index: a header
        (``FAHD``) and one data block (``FADB``), whose entries are paged
        past ``2^page_bits``, each page checksummed and present where the
        block's bitmap says so."""
        f, buf = self._file, self._file.buf
        hdr = self._addr_data
        what = f"{self.name}'s fixed-array header"
        f.signature(hdr, b"FAHD", what)
        client, entry, page_bits = buf[hdr + 5], buf[hdr + 6], buf[hdr + 7]
        count = f.length(hdr + 8)
        block = f.offset(hdr + 8 + f.sl)
        f.checksum(hdr, hdr + 8 + f.sl + f.so, what)
        what = f"{self.name}'s fixed-array data block"
        f.signature(block, b"FADB", what)
        page = 1 << page_bits
        pages = -(-count // page) if count > page else 0
        q = block + 6 + f.so
        if pages:
            bitmap = buf[q:q + (pages + 7) // 8]
            f.checksum(block, q + len(bitmap), what)
            q += len(bitmap) + 4
            spans = []
            for k in range(pages):
                n = min(page, count - k * page)
                if bitmap[k // 8] & (0x80 >> (k % 8)):
                    f.checksum(q, q + n * entry, what + "'s page")
                    spans.append((k * page, q, n))
                q += n * entry + 4
        else:
            f.checksum(block, q + count * entry, what)
            spans = [(0, q, count)]
        return self._entries(spans, entry, client == 1, what)

    def _earray_entries(self) -> tuple:
        """The entries (``_entries``) of an extensible-array index: a header
        (``EAHD``), an index block (``EAIB``) holding the first entries and
        the addresses of the first data blocks (``EADB``) and of secondary
        blocks (``EASB``), each of which holds the addresses of its data
        blocks.  Super block u has 2^(u/2) data blocks of min * 2^((u+1)/2)
        entries (``H5EA__hdr_init``); the first 2 log2(min pointers) super
        blocks' data blocks hang from the index block; a data block of more
        than 2^page_bits entries is paged, and its secondary block's bitmap
        says which pages exist.  Every block is checksummed."""
        f, buf = self._file, self._file.buf
        so, hdr = f.so, self._addr_data
        what = f"{self.name}'s extensible-array header"
        f.version0(hdr, b"EAHD", what)
        f.need(hdr, 16 + 6 * f.sl + so, what)
        client, esize, max_bits, first, min_elements, min_pointers, \
            page_bits = buf[hdr + 5:hdr + 12]
        max_set = f.length(hdr + 12 + 4 * f.sl)
        iblock = f.offset(hdr + 12 + 6 * f.sl)
        f.checksum(hdr, hdr + 12 + 6 * f.sl + so, what)
        if iblock is None:
            return self._entries([], esize, client == 1, what)
        supers = 1 + max_bits - _log2(min_elements)
        in_iblock = 2 * _log2(min_pointers)
        ndblocks = 2 * (min_pointers - 1)
        off_size, page = (max_bits + 7) // 8, 1 << page_bits
        what = f"{self.name}'s extensible-array index block"
        f.version0(iblock, b"EAIB", what)
        p = iblock + 6 + so
        f.need(p, first * esize + (ndblocks + supers - in_iblock) * so, what)
        spans = [(0, p, first)]
        p += first * esize
        dblocks = [f.offset(p + i * so) for i in range(ndblocks)]
        p += ndblocks * so
        sblocks = [f.offset(p + i * so) for i in range(supers - in_iblock)]
        f.checksum(iblock, p + len(sblocks) * so, what)
        start = first
        for u in range(supers):
            if start >= max_set:
                break
            count, n = 1 << (u // 2), min_elements << ((u + 1) // 2)
            npages = n // page if n > page else 0
            bitmap = None
            if u < in_iblock:
                addrs, dblocks = dblocks[:count], dblocks[count:]
            else:
                addrs, bitmap = self._earray_sblock(
                    sblocks[u - in_iblock], count, -(-npages // 8), off_size)
            for k, a in enumerate(addrs):
                if a is None:
                    continue
                what = f"{self.name}'s extensible-array data block"
                f.version0(a, b"EADB", what)
                q = a + 6 + so + off_size
                if not npages:
                    f.checksum(a, q + n * esize, what)
                    spans.append((start + k * n, q, n))
                    continue
                if bitmap is None:
                    raise NotImplementedError(
                        f"{f.path}: {what}: a paged data block in the index "
                        "block")
                f.checksum(a, q, what)
                q += 4
                for j in range(npages):
                    bit = k * npages + j
                    if bitmap[bit // 8] & (0x80 >> (bit % 8)):
                        f.checksum(q, q + page * esize, what + "'s page")
                        spans.append((start + k * n + j * page, q, page))
                    q += page * esize + 4
            start += count * n
        return self._entries(spans, esize, client == 1, what)

    def _earray_sblock(self, addr: Optional[int], count: int,
                       bitmap_bytes: int, off_size: int) -> tuple:
        """(data block addresses, page bitmap or None) of the secondary
        block at ``addr``; an undefined block has no data blocks."""
        if addr is None:
            return [None] * count, None
        f = self._file
        what = f"{self.name}'s extensible-array secondary block"
        f.version0(addr, b"EASB", what)
        p = addr + 6 + f.so + off_size
        bitmap_size = count * bitmap_bytes
        f.need(p, bitmap_size + count * f.so, what)
        bitmap = f.buf[p:p + bitmap_size] if bitmap_bytes else None
        p += bitmap_size
        f.checksum(addr, p + count * f.so, what)
        return [f.offset(p + i * f.so) for i in range(count)], bitmap

    def _unfilter(self, data: bytes, mask: int, what: str) -> bytes:
        path = self._file.path
        for i in reversed(range(len(self._filters))):
            if mask >> i & 1:
                continue
            fid, name, values = self._filters[i]
            if fid == 1:
                try:
                    data = zlib.decompress(data)
                except zlib.error as e:
                    raise ValueError(f"{path}: {what}: deflate: {e}") from e
            elif fid == 2:
                data = _unshuffle(data, values[0] if values else
                                  self.dtype.itemsize)
            elif fid == 3:
                if len(data) < 4 or not _fletcher32_matches(
                        data[:-4], struct.unpack("<I", data[-4:])[0]):
                    raise ValueError(f"{path}: {what}: fletcher32 checksum "
                                     "mismatch")
                data = data[:-4]
            elif fid == LZF_FILTER:
                data = _unlzf(data, f"{path}: {what}")
            elif fid == VBZ_FILTER:
                raise NotImplementedError(
                    f"{path}: {self.name}: the VBZ compression filter (HDF5 "
                    f"filter {VBZ_FILTER}); rewrite the files with gzip, for "
                    "example with ont_fast5_api's `compress_fast5 "
                    "--compression gzip`")
            else:
                label = name or _FILTER_NAMES.get(fid, "unnamed")
                raise NotImplementedError(f"{path}: {self.name}: HDF5 filter "
                                          f"{fid} ({label})")
        return data


def open_file(path: str) -> Group:
    """The root group of the HDF5 file at ``path``, read in one call."""
    with open(path, "rb") as fh:
        buf = fh.read()
    f = _File(buf, str(path))
    return f.object(f.root_address, "/")


# --------------------------------------------------------------------------
# writer: superblock 0, version 1 object headers, old-style groups,
# contiguous datasets

_UNDEF = b"\xff" * 8
_LEAF_K, _NODE_K = 4, 16  # HDF5's defaults: 8 symbols a node, 32 children


def _encode_type(dtype: np.dtype) -> bytes:
    """The version 1 datatype message of ``dtype``."""
    order = 1 if dtype.byteorder == ">" else 0
    size = dtype.itemsize
    if dtype.kind in "iu":
        bits = order | (8 if dtype.kind == "i" else 0)
        return struct.pack("<BBBBIHH", 0x10, bits, 0, 0, size, 0, 8 * size)
    if dtype.kind == "f" and size in (4, 8):
        _, eloc, esize, mloc, msize, bias = next(
            t for t in _IEEE if t[0] == size)
        return struct.pack("<BBBBIHHBBBBI", 0x11, order | 0x20, 8 * size - 1,
                           0, size, 0, 8 * size, eloc, esize, mloc, msize,
                           bias)
    if dtype.kind == "S":
        return struct.pack("<BBBBI", 0x13, 1, 0, 0, size)  # null-padded
    if dtype.names:
        body = b""
        for name in dtype.names:
            member, offset = dtype.fields[name][:2]
            raw = name.encode() + b"\0"
            body += raw + bytes(_pad8(len(raw)) - len(raw))
            body += struct.pack("<IB3xI4x16x", offset, 0, 0)
            body += _encode_type(member)
        n = len(dtype.names)
        return struct.pack("<BBBBI", 0x16, n & 0xFF, n >> 8, 0, size) + body
    raise TypeError(f"no HDF5 type is written for {dtype}")


def _encode_space(shape: tuple) -> bytes:
    """The version 1 dataspace message of ``shape`` (rank 0: scalar)."""
    return struct.pack(f"<BBBB4x{len(shape)}Q", 1, len(shape), 0, 0, *shape)


def _as_array(value) -> np.ndarray:
    if isinstance(value, str):
        value = value.encode("utf-8")
    arr = np.asarray(value)
    if arr.dtype.kind == "U":
        arr = np.char.encode(arr, "utf-8")
    if arr.dtype.kind == "S" and arr.dtype.itemsize == 0:
        arr = arr.astype("S1")
    return arr


class _Writer:
    def __init__(self, attrs: dict):
        self.buf = bytearray(96)  # the superblock, written last
        self.attrs = attrs

    def put(self, data: bytes) -> int:
        self.buf += bytes(_pad8(len(self.buf)) - len(self.buf))
        at = len(self.buf)
        self.buf += data
        return at

    def header(self, messages: list, path: str) -> int:
        for name, value in self.attrs.get(path, {}).items():
            messages.append((_ATTRIBUTE, self.attribute(name, value)))
        body = b"".join(struct.pack("<HHB3x", t, _pad8(len(d)), 0) + d +
                        bytes(_pad8(len(d)) - len(d)) for t, d in messages)
        return self.put(struct.pack("<BBHII4x", 1, 0, len(messages), 1,
                                    len(body)) + body)

    @staticmethod
    def attribute(name: str, value) -> bytes:
        arr = _as_array(value)
        raw = name.encode("utf-8") + b"\0"
        dtype, space = _encode_type(arr.dtype), _encode_space(arr.shape)
        return (struct.pack("<BBHHH", 1, 0, len(raw), len(dtype), len(space))
                + b"".join(x + bytes(_pad8(len(x)) - len(x))
                           for x in (raw, dtype, space)) + arr.tobytes())

    def dataset(self, value, path: str) -> int:
        arr = _as_array(value)
        addr = self.put(arr.tobytes()) if arr.nbytes else None
        layout = struct.pack("<BB", 3, 1) + (
            _UNDEF if addr is None else struct.pack("<Q", addr)) + \
            struct.pack("<Q", arr.nbytes)
        return self.header([(_DATASPACE, _encode_space(arr.shape)),
                            (_DATATYPE, _encode_type(arr.dtype)),
                            (_FILL, struct.pack("<BBBBI", 2, 2, 2, 1, 0)),
                            (_LAYOUT, layout)], path)

    def group(self, members: dict, path: str) -> tuple:
        """(header, B-tree, local heap) addresses of the group ``members``
        at ``path``."""
        names = sorted(members, key=lambda n: n.encode("utf-8"))
        if len(names) > 2 * _LEAF_K * 2 * _NODE_K:
            raise ValueError(f"{path or '/'}: more than "
                             f"{4 * _LEAF_K * _NODE_K} members")
        entries = []
        for name in names:
            child = f"{path}/{name}"
            value = members[name]
            if isinstance(value, dict):
                h, tree, heap = self.group(value, child)
                entries.append((name, h, 1, struct.pack("<QQ", tree, heap)))
            else:
                entries.append((name, self.dataset(value, child), 0,
                                bytes(16)))
        heap_data = bytearray(8)  # offset 0: the empty name
        offsets = []
        for name, *_ in entries:
            offsets.append(len(heap_data))
            raw = name.encode("utf-8") + b"\0"
            heap_data += raw + bytes(_pad8(len(raw)) - len(raw))
        heap = len(self.buf) + (-len(self.buf)) % 8
        # free list offset 1: HDF5's code for "no free block"
        self.put(b"HEAP" + bytes(4) + struct.pack(
            "<QQQ", len(heap_data), 1, heap + 32) + heap_data)
        nodes = []
        for lo in range(0, len(entries), 2 * _LEAF_K):
            part = entries[lo:lo + 2 * _LEAF_K]
            body = b"".join(struct.pack("<QQI4x", off, h, cache) + scratch
                            for off, (_, h, cache, scratch)
                            in zip(offsets[lo:], part))
            nodes.append((self.put(
                b"SNOD" + struct.pack("<BBH", 1, 0, len(part)) + body
                + bytes(40 * (2 * _LEAF_K - len(part)))),
                offsets[lo + len(part) - 1]))
        keys = struct.pack("<Q", 0) + b"".join(
            struct.pack("<QQ", node, last) for node, last in nodes)
        tree = self.put(b"TREE" + struct.pack("<BBH", 0, 0, len(nodes))
                        + _UNDEF + _UNDEF + keys
                        + bytes(16 * (2 * _NODE_K - len(nodes))))
        h = self.header([(_SYMBOL_TABLE, struct.pack("<QQ", tree, heap))],
                        path or "/")
        return h, tree, heap

    def superblock(self, root: tuple) -> bytes:
        h, tree, heap = root
        return (SIGNATURE + bytes([0, 0, 0, 0, 0, 8, 8, 0])
                + struct.pack("<HHI", _LEAF_K, _NODE_K, 0)
                + struct.pack("<Q", 0) + _UNDEF
                + struct.pack("<Q", len(self.buf)) + _UNDEF
                + struct.pack("<QQI4xQQ", 0, h, 1, tree, heap))


def write_file(path: str, tree: dict, attrs: Optional[dict] = None) -> None:
    """Write ``tree`` to ``path`` as HDF5: each ``dict`` a group, each other
    value a contiguous dataset of ``np.asarray(value)``.  ``attrs`` maps an
    object's path ("/" for the root, "a/b" below it) to its attributes."""
    attrs = {("/" + k.strip("/")) if k.strip("/") else "/": v
             for k, v in (attrs or {}).items()}
    w = _Writer(attrs)
    root = w.group(tree, "")
    w.buf[:96] = w.superblock(root)
    with open(path, "wb") as fh:
        fh.write(w.buf)
