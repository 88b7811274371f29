"""The port's HDF5 reader and writer (``deepsignal_tpu_torch/io/hdf5.py``)
against h5py: files h5py writes over a grid of formats, layouts, filters,
types, attributes and group sizes read as h5py reads them; the writer's
files read by h5py as the written values; every refused feature raises an
error that names it; and the committed fast5 fixtures read as the JAX
package's reader reads them."""

import ctypes
import dataclasses
import importlib.util
import math
import os
import struct
import zlib

import h5py
import numpy as np
import pytest

from deepsignal_tpu.io import fast5 as jax_fast5
from deepsignal_tpu_torch.io import fast5, hdf5

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures", "fast5")
FIXTURE_FILES = ("synthetic", "tombo_like", "latest", "no_alignment",
                 "tombo_latest")
STRAND = "Analyses/RawGenomeCorrected_000/BaseCalled_template"

GRID_DTYPES = ("<i2", "<i4", "<u4", "<f4", "<f8", ">i2", ">f8")
STORAGE = (("contiguous", ()), ("compact", ()), ("chunked", ()),
           ("chunked", ("gzip",)), ("chunked", ("gzip", "shuffle")),
           ("chunked", ("fletcher32",)))
TOMBO_EVENTS = [("norm_mean", "<f8"), ("norm_stdev", "<f8"),
                ("start", "<u4"), ("length", "<u4"), ("base", "S1")]
WRITER_EVENTS = [("start", "<i8"), ("length", "<i8"), ("base", "S1")]


def _values(rng, dtype, n):
    dtype = np.dtype(dtype)
    if dtype.kind == "f":
        return rng.normal(0, 100, n).astype(dtype)
    info = np.iinfo(dtype)
    return rng.integers(max(info.min, -30000), min(info.max, 30000) + 1,
                        n).astype(dtype)


def _create(h5, name, data, storage, filters=(), chunks=None, **kw):
    """A dataset of ``data`` written by h5py; "compact" through the
    low-level API, which alone sets that layout."""
    if storage == "compact":
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_layout(h5py.h5d.COMPACT)
        h5py.h5d.create(h5.id, name.encode(), h5py.h5t.py_create(data.dtype),
                        h5py.h5s.create_simple(data.shape), dcpl=dcpl)
        h5[name][...] = data
        return h5[name]
    if storage == "chunked":
        kw["chunks"] = chunks or tuple(max(1, s // 3) for s in data.shape)
        kw["compression"] = "gzip" if "gzip" in filters else None
        kw["shuffle"] = "shuffle" in filters
        kw["fletcher32"] = "fletcher32" in filters
    return h5.create_dataset(name, data=data, **kw)


def _same(got, want):
    """``got`` (the port's) is what h5py gives: type, dtype and values."""
    assert type(got) is type(want), (type(got), type(want))
    if isinstance(want, np.ndarray) or isinstance(want, np.generic):
        assert got.dtype == want.dtype, (got.dtype, want.dtype)
        assert got.shape == want.shape
        if want.dtype.names:
            for name in want.dtype.names:
                np.testing.assert_array_equal(got[name], want[name])
        else:
            np.testing.assert_array_equal(got, want)
    else:
        assert got == want


def _name_order(group):
    """h5py's members of ``group`` through its name index in increasing
    order, the order of ``H5Gget_objname_by_idx`` (which rebuilds the list
    on each call)."""
    names = []
    group.id.links.iterate(names.append, idx_type=h5py.h5.INDEX_NAME,
                           order=h5py.h5.ITER_INC)
    return [n.decode() for n in names]


def _same_file(path):
    """Every dataset and attribute of the file at ``path`` reads through the
    port as through h5py.  Returns the number of objects compared."""
    root = hdf5.open_file(str(path))
    seen = [0]

    def visit(name, obj):
        mine = root.dataset(name) if isinstance(obj, h5py.Dataset) \
            else root.group(name)
        if isinstance(obj, h5py.Dataset):
            assert mine.shape == obj.shape
            got = mine.read()
            _same(got if obj.shape else got[()], obj[()])
        else:
            assert mine.members() == _name_order(obj)
        assert sorted(mine.attrs) == sorted(obj.attrs)
        for key in obj.attrs:
            _same(mine.attrs[key], obj.attrs[key])
        seen[0] += 1

    with h5py.File(path, "r") as h5:
        assert root.members() == list(h5)
        for key in h5.attrs:
            _same(root.attrs[key], h5.attrs[key])
        h5.visititems(visit)
    return seen[0]


def _jax_read(path):
    return jax_fast5.read_resquiggled_fast5(str(path))


def _same_read(got, want):
    assert (got is None) == (want is None)
    if want is None:
        return
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        assert type(a) is type(b), f.name
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name


# --------------------------------------------------------------------------
# h5py's files through the reader


@pytest.mark.parametrize("dtype", GRID_DTYPES)
@pytest.mark.parametrize("storage,filters", STORAGE,
                         ids=["-".join((s,) + f) for s, f in STORAGE])
@pytest.mark.parametrize("libver", ["earliest", "latest"])
def test_datasets_read_as_h5py_reads_them(tmp_path, libver, storage,
                                          filters, dtype):
    rng = np.random.default_rng(zlib.crc32(repr((libver, storage, filters,
                                                 dtype)).encode()))
    data = _values(rng, dtype, 1000)
    path = tmp_path / "x.h5"
    with h5py.File(path, "w", libver=libver) as h5:
        _create(h5, "d", data, storage, filters)
        _create(h5, "g/scalar", np.asarray(data[:1][0]), "contiguous")
    got = hdf5.open_file(str(path)).dataset("d").read()
    assert got.dtype == np.dtype(dtype)
    np.testing.assert_array_equal(got, data)
    assert _same_file(path) == 3


@pytest.mark.parametrize("superblock", [0, 1, 2, 3])
def test_superblock_versions(tmp_path, superblock):
    """Superblock 1 is written where the chunk B-tree's K is not HDF5's
    default (set through h5py's own libhdf5, which h5py does not expose);
    2 by the 1.8 format; 3 by the latest."""
    path = tmp_path / "x.h5"
    if superblock == 1:
        with open("/proc/self/maps") as f:
            lib = next(line.split()[-1] for line in f
                       if "/libhdf5" in line and "libhdf5_hl" not in line
                       and ".so" in line)
        fcpl = h5py.h5p.create(h5py.h5p.FILE_CREATE)
        assert ctypes.CDLL(lib).H5Pset_istore_k(
            ctypes.c_int64(fcpl.id), ctypes.c_uint(64)) >= 0
        h5py.h5f.create(str(path).encode(), fcpl=fcpl).close()
        mode, libver = "a", "earliest"
    else:
        mode, libver = "w", {0: "earliest", 2: "v108", 3: "latest"}[
            superblock]
    with h5py.File(path, mode, libver=libver) as h5:
        _create(h5, "g/d", np.arange(500, dtype="<i4"), "chunked", ("gzip",))
        h5["g"].attrs["a"] = np.float64(0.25)
    assert path.read_bytes()[8] == superblock
    assert _same_file(path) == 2


@pytest.mark.parametrize("libver", ["earliest", "latest"])
@pytest.mark.parametrize("filters", [(), ("gzip", "shuffle")])
def test_two_dimensional_chunks_with_partial_edges(tmp_path, libver,
                                                   filters):
    data = np.arange(37 * 23, dtype="<f4").reshape(37, 23)
    path = tmp_path / "x.h5"
    with h5py.File(path, "w", libver=libver) as h5:
        _create(h5, "d", data, "chunked", filters, chunks=(8, 5))
    np.testing.assert_array_equal(
        hdf5.open_file(str(path)).dataset("d").read(), data)
    assert _same_file(path) == 1


@pytest.mark.parametrize("libver", ["earliest", "latest"])
def test_unwritten_data_reads_as_the_fill_value(tmp_path, libver):
    path = tmp_path / "x.h5"
    with h5py.File(path, "w", libver=libver) as h5:
        d = h5.create_dataset("chunked", shape=(1000,), dtype="<i4",
                              chunks=(100,), fillvalue=-7)
        d[250:330] = np.arange(80)
        h5.create_dataset("contiguous", shape=(50,), dtype="<f8",
                          fillvalue=2.5)
        h5.create_dataset("zeros", shape=(20,), dtype="<i2", chunks=(5,))
    root = hdf5.open_file(str(path))
    want = np.full(1000, -7, "<i4")
    want[250:330] = np.arange(80)
    np.testing.assert_array_equal(root.dataset("chunked").read(), want)
    np.testing.assert_array_equal(root.dataset("contiguous").read(),
                                  np.full(50, 2.5))
    np.testing.assert_array_equal(root.dataset("zeros").read(),
                                  np.zeros(20, "<i2"))
    assert _same_file(path) == 3


@pytest.mark.parametrize("index,filters", [
    ("single", ()), ("single", ("gzip",)), ("implicit", ()),
    ("paged fixed array", ()), ("paged fixed array", ("gzip", "shuffle"))])
def test_layout_4_chunk_indexes(tmp_path, index, filters):
    data = np.arange(3001, dtype="<i4") * 7 - 5000
    path = tmp_path / "x.h5"
    with h5py.File(path, "w", libver="latest") as h5:
        if index == "implicit":
            dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
            dcpl.set_chunk((100,))
            dcpl.set_alloc_time(h5py.h5d.ALLOC_TIME_EARLY)
            h5py.h5d.create(h5.id, b"d", h5py.h5t.py_create(data.dtype),
                            h5py.h5s.create_simple(data.shape), dcpl=dcpl)
            h5["d"][...] = data
        else:
            chunks = data.shape if index == "single" else (2,)
            _create(h5, "d", data, "chunked", filters, chunks=chunks)
    d = hdf5.open_file(str(path)).dataset("d")
    assert d._index == {"single": "single", "implicit": "implicit",
                        "paged fixed array": "farray"}[index]
    np.testing.assert_array_equal(d.read(), data)


@pytest.mark.parametrize("strings", ["fixed", "variable"])
@pytest.mark.parametrize("libver", ["earliest", "latest"])
def test_attributes_read_as_h5py_reads_them(tmp_path, libver, strings):
    def text(s):
        return np.bytes_(s.encode()) if strings == "fixed" else s

    path = tmp_path / "x.h5"
    with h5py.File(path, "w", libver=libver) as h5:
        g = h5.create_group("g")
        d = h5.create_dataset("g/d", data=np.arange(4, dtype="<i2"))
        for obj in (h5, g, d):
            obj.attrs["name"] = text("chr1")
            obj.attrs["utf8"] = text("méthylé")
            obj.attrs["empty"] = text("")
        g.attrs["i8"] = np.int8(-3)
        g.attrs["u64"] = np.uint64(2 ** 63 + 5)
        g.attrs["f4"] = np.float32(1.5)
        d.attrs["array"] = np.arange(6, dtype=">i4").reshape(2, 3)
        d.attrs["strings"] = np.array([b"ab", b"cde"]) if strings == "fixed" \
            else np.array(["ab", "cde"], dtype=h5py.string_dtype())
    assert _same_file(path) == 2
    assert hdf5.open_file(str(path)).group("g").attrs["name"] == text("chr1")


@pytest.mark.parametrize("pad", ["STR_NULLTERM", "STR_NULLPAD",
                                 "STR_SPACEPAD"])
def test_fixed_length_string_paddings(tmp_path, pad):
    tid = h5py.h5t.C_S1.copy()
    tid.set_size(6)
    tid.set_strpad(getattr(h5py.h5t, pad))
    raw = np.array([b"ab    ", b"abcdef", b"a\0\0\0\0\0"], dtype="S6")
    if pad != "STR_SPACEPAD":
        raw = np.array([b"ab", b"abcdef", b"a"], dtype="S6")
    path = tmp_path / "x.h5"
    with h5py.File(path, "w") as h5:
        did = h5py.h5d.create(h5.id, b"s", tid, h5py.h5s.create_simple((3,)))
        did.write(h5py.h5s.ALL, h5py.h5s.ALL, raw, mtype=tid)
        aid = h5py.h5a.create(did, b"a", tid, h5py.h5s.create(h5py.h5s.SCALAR))
        aid.write(raw[:1].reshape(()), mtype=tid)
    assert _same_file(path) == 1


@pytest.mark.parametrize("libver", ["earliest", "latest"])
def test_variable_length_string_datasets(tmp_path, libver):
    path = tmp_path / "x.h5"
    with h5py.File(path, "w", libver=libver) as h5:
        h5.create_dataset("fastq", data="@r\nACGT\n+\nIIII\n")
        h5.create_dataset("many", data=np.array(["a", "", "ccc" * 50],
                                                dtype=h5py.string_dtype()))
    root = hdf5.open_file(str(path))
    assert root.dataset("fastq").read()[()] == b"@r\nACGT\n+\nIIII\n"
    assert root.dataset("many").read().tolist() == [b"a", b"", b"ccc" * 50]
    assert _same_file(path) == 2


@pytest.mark.parametrize("storage", ["contiguous", "gzip"])
@pytest.mark.parametrize("fields", [TOMBO_EVENTS, WRITER_EVENTS],
                         ids=["tombo", "writer"])
@pytest.mark.parametrize("libver", ["earliest", "latest"])
def test_events_compounds(tmp_path, libver, fields, storage):
    rng = np.random.default_rng(5)
    ev = np.zeros(300, dtype=fields)
    for name, t in fields:
        ev[name] = rng.choice(list(b"ACGT"), 300).astype("u1").view("S1") \
            if t == "S1" else _values(rng, t, 300)
    path = tmp_path / "x.h5"
    with h5py.File(path, "w", libver=libver) as h5:
        if storage == "gzip":
            h5.create_dataset("Events", data=ev, compression="gzip")
        else:
            h5.create_dataset("Events", data=ev)
        h5["Events"].attrs["read_start_rel_to_raw"] = np.int64(9)
    got = hdf5.open_file(str(path)).dataset("Events").read()
    assert got.dtype.names == tuple(n for n, _ in fields)
    for name, _ in fields:
        np.testing.assert_array_equal(got[name], ev[name])
    assert _same_file(path) == 1


@pytest.mark.parametrize("libver,members", [
    ("earliest", 1), ("earliest", 20), ("earliest", 300), ("latest", 1),
    ("latest", 8)])
def test_group_members_in_name_order(tmp_path, libver, members):
    """20 members fill three symbol nodes; 300 split the group's B-tree
    into two levels; a group of the latest format holds 8 links in its
    header."""
    rng = np.random.default_rng(members)
    names = [f"Read_{i}" for i in rng.permutation(members)]
    path = tmp_path / "x.h5"
    with h5py.File(path, "w", libver=libver) as h5:
        g = h5.create_group("Raw/Reads")
        for name in names:
            g.create_group(name).create_dataset(
                "Signal", data=np.full(3, len(name), "<i2"))
    root = hdf5.open_file(str(path))
    with h5py.File(path, "r") as h5:
        gid = h5["Raw/Reads"].id
        want = [gid.get_objname_by_idx(i).decode() for i in range(members)]
    assert root.group("Raw/Reads").members() == want == \
        sorted(names, key=str.encode)
    for name in names:
        np.testing.assert_array_equal(
            root.dataset(f"Raw/Reads/{name}/Signal").read(),
            np.full(3, len(name), "<i2"))
    if members == 300:
        assert _same_file(path) == 2 + 2 * members


# --------------------------------------------------------------------------
# HDF5 1.8's dense storage and 1.10's chunk indexes

NEW_FORMATS = ("v108", "v110", "latest")
# pairs of names whose lookup3 hashes are equal (a search over "m%07d")
COLLIDING = (("m0191687", "m0265875"), ("m0056596", "m0385332"))


def _attribute_value(rng, i, strings):
    """A varied attribute by its index: an integer, a string of the given
    kind, a float array, a compound, an array of strings."""
    kind = i % 5
    if kind == 0:
        return np.int64(i)
    if kind == 1:
        return f"value-{i}" if strings == "variable" else \
            np.bytes_(f"value-{i}".encode())
    if kind == 2:
        return rng.normal(size=3).astype("<f8")
    if kind == 3:
        rec = np.zeros((), dtype=TOMBO_EVENTS)
        rec["start"], rec["base"] = i, b"C"
        return rec
    return np.array([f"s{i}", "t"], dtype=h5py.string_dtype()) \
        if strings == "variable" else np.array([b"s%d" % i, b"t"])


def _read_all(path):
    """Everything in the file through the port alone: every member, every
    attribute and every dataset."""
    def visit(obj):
        for key in obj.attrs:
            obj.attrs[key]
        if isinstance(obj, hdf5.Dataset):
            obj.read()
            return
        for name in obj.members():
            visit(obj._get(name))

    visit(hdf5.open_file(str(path)))


@pytest.mark.parametrize("where", ["group", "dataset"])
@pytest.mark.parametrize("count,strings", [
    (9, "variable"), (9, "fixed"), (40, "variable"), (40, "fixed"),
    (300, "variable"), (300, "fixed"), (2000, "variable")])
@pytest.mark.parametrize("libver", NEW_FORMATS)
def test_dense_attributes_read_as_h5py_reads_them(tmp_path, libver, count,
                                                  strings, where):
    """Past 8 attributes an object's attributes are stored densely; 40 fill
    more than the heap's first block (an indirect root block); 300 and
    2,000 give the name index one and two levels of internal nodes."""
    rng = np.random.default_rng(count)
    path = tmp_path / "x.h5"
    with h5py.File(path, "w", libver=libver) as h5:
        obj = h5.create_group("o") if where == "group" else \
            h5.create_dataset("o", data=np.arange(5, dtype="<i2"))
        for i in rng.permutation(count):
            obj.attrs[f"attr_{i:04d}"] = _attribute_value(rng, i, strings)
    attrs = hdf5.open_file(str(path))._get("o").attrs
    assert attrs._dense is not None
    assert attrs["attr_0001"] == ("value-1" if strings == "variable"
                                  else np.bytes_(b"value-1"))
    with pytest.raises(KeyError):
        attrs["attr_9999"]
    assert list(attrs) == [f"attr_{i:04d}" for i in range(count)]
    assert len(attrs) == count
    assert _same_file(path) == 1


@pytest.mark.parametrize("libver", NEW_FORMATS)
def test_a_large_attribute_is_a_huge_heap_object(tmp_path, monkeypatch,
                                                libver):
    """An attribute of 160 KB does not fit an object header, so HDF5 stores
    the attributes densely even among few, and the message, past the
    heap's largest managed object, as a huge object found through the
    heap's own version 2 B-tree (records of type 1)."""
    big = np.arange(20000, dtype="<f8")
    path = tmp_path / "x.h5"
    with h5py.File(path, "w", libver=libver) as h5:
        d = h5.create_dataset("d", data=np.arange(3, dtype="<i4"))
        d.attrs["small"] = np.int32(7)
        d.attrs["big"] = big
    trees = []
    real = hdf5._BTree2.__init__

    def spy(self, *args):
        real(self, *args)
        trees.append(self.type)

    monkeypatch.setattr(hdf5._BTree2, "__init__", spy)
    attrs = hdf5.open_file(str(path)).dataset("d").attrs
    np.testing.assert_array_equal(attrs["big"], big)
    assert trees == [8, 1]
    assert _same_file(path) == 1


@pytest.mark.parametrize("libver", NEW_FORMATS)
def test_a_heap_with_indirect_child_blocks(tmp_path, libver):
    """600 attributes of 1 KB (~600 KB) outgrow the root indirect block's
    direct rows (up to 64 KB blocks), so the heap has child indirect
    blocks."""
    path = tmp_path / "x.h5"
    with h5py.File(path, "w", libver=libver) as h5:
        g = h5.create_group("g")
        for i in range(600):
            g.attrs[f"a{i:03d}"] = np.full(128, i, "<f8")
    assert path.read_bytes().count(b"FHIB") > 1
    attrs = hdf5.open_file(str(path)).group("g").attrs
    for i in (0, 299, 599):
        np.testing.assert_array_equal(attrs[f"a{i:03d}"], np.full(128, i))
    assert _same_file(path) == 1


@pytest.mark.parametrize("track_order", [False, True], ids=["name", "order"])
@pytest.mark.parametrize("members", [9, 64, 1000, 3000])
@pytest.mark.parametrize("libver", NEW_FORMATS)
def test_dense_links_read_as_h5py_reads_them(tmp_path, libver, members,
                                             track_order):
    """Past 8 links a group's links are stored densely; 64, 1,000 and
    3,000 give the name index one and two levels of internal nodes.  Each
    link is a hard link to one of 8 datasets (holding its number modulo
    8); members list in name order whatever the creation order, and each
    is looked up by its name's hash."""
    rng = np.random.default_rng(members)
    order = rng.permutation(members)
    path = tmp_path / "x.h5"
    with h5py.File(path, "w", libver=libver) as h5:
        targets = [h5.create_dataset(f"t{k}", data=np.int16(k))
                   for k in range(8)]
        g = h5.create_group("g", track_order=track_order)
        for i in order:
            g[f"Read_{i}"] = targets[i % 8]
        want = _name_order(g)
    root = hdf5.open_file(str(path))
    g = root.group("g")
    assert g._dense_links() is not None
    for i in order[:50]:
        assert root.dataset(f"g/Read_{i}").read()[()] == i % 8
    with pytest.raises(KeyError, match="no member 'Read_x'"):
        g.dataset("Read_x")
    assert g.members() == want == sorted((f"Read_{i}" for i in order),
                                         key=str.encode)
    assert _same_file(path) == 9


@pytest.mark.parametrize("libver", NEW_FORMATS)
def test_names_whose_hashes_collide(tmp_path, libver):
    """Two names with one lookup3 hash: each is found by name, as a link and
    as an attribute, and a name that shares a present name's hash but is
    absent is not."""
    (a, b), (c, d) = COLLIDING
    assert hdf5.lookup3(a.encode()) == hdf5.lookup3(b.encode())
    assert hdf5.lookup3(c.encode()) == hdf5.lookup3(d.encode())
    path = tmp_path / "x.h5"
    with h5py.File(path, "w", libver=libver) as h5:
        g = h5.create_group("g")
        for k, name in enumerate((a, b, c) + tuple(f"x{i}" for i in
                                                   range(10))):
            g.create_dataset(name, data=np.int32(k))
            g.attrs[name] = np.int32(-k)
    g = hdf5.open_file(str(path)).group("g")
    assert g._dense_links() is not None and g.attrs._dense is not None
    assert [g.dataset(n).read()[()] for n in (a, b, c)] == [0, 1, 2]
    assert [g.attrs[n] for n in (a, b, c)] == [0, -1, -2]
    with pytest.raises(KeyError):
        g.dataset(d)
    with pytest.raises(KeyError):
        g.attrs[d]
    assert _same_file(path) == 14


@pytest.mark.parametrize("libver", NEW_FORMATS)
def test_colliding_names_on_both_sides_of_a_node_key(tmp_path, libver):
    """Equal name hashes in an internal node and in a leaf below it: the
    lookup descends into every child whose bounding keys admit the hash,
    bounds included, and finds both names.  The pair goes in first, then
    21 names that hash below it and 30 above, so that the root leaf's split
    lifts one of the pair into the root (h5py's name index, depth 1)."""
    (a, b), _ = COLLIDING
    h = hdf5.lookup3(a.encode())
    names = [f"x{i}" for i in range(3000)]
    low = [n for n in names if hdf5.lookup3(n.encode()) < h][:21]
    high = [n for n in names if hdf5.lookup3(n.encode()) > h][:30]
    path = tmp_path / "x.h5"
    with h5py.File(path, "w", libver=libver) as h5:
        g = h5.create_group("g")
        for k, name in enumerate([a, b] + low + high):
            g.create_dataset(name, data=np.int32(k))
    g = hdf5.open_file(str(path)).group("g")
    tree = g._dense_links().tree
    visited = []
    walk = hdf5._BTree2._node

    def spy(self, addr, nrec, depth, key, match, out):
        visited.append((addr, depth))
        walk(self, addr, nrec, depth, key, match, out)

    hdf5._BTree2._node = spy
    try:
        found = tree.records(lambda r: struct.unpack_from("<I", tree.f.buf,
                                                          r)[0], h)
    finally:
        hdf5._BTree2._node = walk
    # the depth of the node holding each record of the hash
    depths = sorted(max((at, d) for at, d in visited if at < r)[1]
                    for r in found)
    assert tree.depth == 1 and depths == [0, 1]
    assert [g.dataset(n).read()[()] for n in (a, b)] == [0, 1]
    assert _same_file(path) == 1 + 2 + len(low) + len(high)  # g too


def _with_max_managed(src: str, dst, value: int) -> int:
    """Copy ``src`` to ``dst`` with every fractal heap header's maximum
    managed object size set to ``value`` and its checksum recomputed with
    the port's lookup3; returns the number of heaps.  The header's layout
    is that of 8-byte offsets and lengths, checked by the old checksum."""
    buf = bytearray(open(src, "rb").read())
    heaps = 0
    at = buf.find(b"FRHP")
    while at >= 0:
        end = at + 14 + 10 * 8 + 2 * 8 + 8 + 2 * 8 + 8  # to the checksum
        assert struct.unpack_from("<I", buf, end)[0] == \
            hdf5.lookup3(bytes(buf[at:end]))
        struct.pack_into("<I", buf, at + 10, value)
        struct.pack_into("<I", buf, end, hdf5.lookup3(bytes(buf[at:end])))
        heaps += 1
        at = buf.find(b"FRHP", at + 4)
    dst.write_bytes(bytes(buf))
    return heaps


@pytest.mark.parametrize("max_managed", [1 << 16, 1 << 24])
def test_a_heap_ids_length_takes_the_narrower_width(tmp_path, max_managed):
    """A managed object's length in a heap ID takes the narrower of the
    widths of the largest direct block's offsets and of the maximum
    managed object size (``H5HF__hdr_finish_init``).  h5py's heaps have a
    64 KB direct block and a 4 KB maximum, where both are 2 bytes; raised
    to 64 KB or 16 MB the maximum's width is 3 or 4 bytes, and the file
    still reads as h5py reads it."""
    src = os.path.join(FIXTURES, "tombo_latest.fast5")
    path = tmp_path / "wide.fast5"
    assert _with_max_managed(src, path, max_managed) == 4
    assert hdf5._enc_size(max_managed) > 2
    root = hdf5.open_file(str(path))
    heap = root.group("UniqueGlobalKey/tracking_id").attrs._dense.heap
    assert heap.len_size == 2
    assert _same_file(path) == _same_file(src)
    _same_read(fast5.read_resquiggled_fast5(str(path)),
               fast5.read_resquiggled_fast5(src))


def test_tiny_heap_objects_are_read_from_the_heap_id(tmp_path):
    """A tiny object lies in its heap ID (type 2, its length less one in
    the low 4 bits of the first byte).  HDF5 stores no link or attribute
    message that small, so the heap of a real file reads IDs appended to
    the file's bytes."""
    path = tmp_path / "x.h5"
    with h5py.File(path, "w", libver="latest") as h5:
        for i in range(10):
            h5.attrs[f"a{i}"] = i
    raw = path.read_bytes()
    f = hdf5._File(raw + b"\x23abcd" + bytes(3) + b"\x20Z" + bytes(6),
                   str(path))
    heap = f.object(f.root_address, "/").attrs._dense.heap
    assert heap.id_len == 8
    assert heap.object(len(raw)) == (len(raw) + 1, 4)
    assert heap.object(len(raw) + 8) == (len(raw) + 9, 1)
    assert f.buf[len(raw) + 1:len(raw) + 5] == b"abcd"


def _signal(path, libver, n, chunk, filters, holes=(), fill=-1):
    """A ``Signal``-like 1-D int16 dataset of ``n`` samples at maxshape
    (None,) in chunks of ``chunk``; the spans in ``holes`` never written.
    Returns the values h5py reads."""
    data = (np.arange(n) % 30011 - 15000).astype("<i2")
    with h5py.File(path, "w", libver=libver) as h5:
        d = h5.create_dataset("Signal", shape=(n,), maxshape=(None,),
                              chunks=(chunk,), dtype="<i2", fillvalue=fill,
                              compression="gzip" if filters else None,
                              shuffle=bool(filters),
                              fletcher32=bool(filters))
        lo = 0
        for start, stop in sorted(holes) + [(n, n)]:
            if lo < start:
                d[lo:start] = data[lo:start]
            lo = stop
        want = d[()]
    return want


# chunk counts: 3 end in the index block (4 entries), 50 in its data
# blocks (240 more), 1,000 in secondary blocks; 131,100 reach the paged
# data blocks (past 131,060 chunks, whose blocks exceed 1,024 entries),
# written only in spans, two of them in two pages of one data block
EA_CASES = {"index_block": (3 * 700 - 77, 700, ()),
            "data_blocks": (50 * 60 - 13, 60, [(1200, 1500)]),
            "secondary_blocks": (1000 * 8 - 3, 8, [(2000, 6000)]),
            "paged": (131100, 1, [(10, 5000), (5010, 131070),
                                  (131100, 132100)])}


@pytest.mark.parametrize("filters", [False, True],
                         ids=["plain", "gzip-shuffle-fletcher32"])
@pytest.mark.parametrize("case", list(EA_CASES))
@pytest.mark.parametrize("libver", ["v110", "latest"])
def test_extensible_array_chunk_index(tmp_path, libver, case, filters):
    """The extensible-array index of a dataset with one unlimited
    dimension, its last chunk partial, with chunks never written (the fill
    value)."""
    n, chunk, holes = EA_CASES[case]
    if case == "paged":  # one more span, in the first data block's 2nd page
        n, holes = 132130, holes[:2] + [(131100, 132089), (132119, 132130)]
    path = tmp_path / "x.h5"
    want = _signal(path, libver, n, chunk, filters, holes)
    d = hdf5.open_file(str(path)).dataset("Signal")
    assert d._index == "earray"
    got = d.read()
    assert got.dtype == np.dtype("<i2")
    np.testing.assert_array_equal(got, want)
    if holes:
        assert (want[holes[0][0]:holes[0][1]] == -1).all()
    signatures = {s: path.read_bytes().count(s)
                  for s in (b"EAIB", b"EASB", b"EADB")}
    assert signatures == {
        "index_block": {b"EAIB": 1, b"EASB": 0, b"EADB": 0},
        "data_blocks": {b"EAIB": 1, b"EASB": 0, b"EADB": 2},
        "secondary_blocks": {b"EAIB": 1, b"EASB": 2, b"EADB": 10},
        "paged": {b"EAIB": 1, b"EASB": 2, b"EADB": 3}}[case]
    assert _same_file(path) == 1


@pytest.mark.parametrize("libver", ["v110", "latest"])
def test_extensible_array_with_a_later_unlimited_dimension(tmp_path, libver):
    """With the unlimited dimension second, HDF5 numbers the chunks with it
    moved first (its swizzle)."""
    data = np.arange(23 * 41, dtype="<f8").reshape(23, 41)
    path = tmp_path / "x.h5"
    with h5py.File(path, "w", libver=libver) as h5:
        h5.create_dataset("d", data=data, chunks=(4, 3), maxshape=(30, None))
    d = hdf5.open_file(str(path)).dataset("d")
    assert d._index == "earray"
    np.testing.assert_array_equal(d.read(), data)
    assert _same_file(path) == 1


@pytest.mark.parametrize("filters", [False, True], ids=["plain", "gzip"])
@pytest.mark.parametrize("shape,chunks,depth", [
    ((10, 10), (3, 3), 0), ((60, 70), (3, 2), 1), ((150, 150), (1, 1), 2)],
    ids=["depth0", "depth1", "depth2"])
@pytest.mark.parametrize("libver", ["v110", "latest"])
def test_version_2_btree_chunk_index(tmp_path, monkeypatch, libver, shape,
                                     chunks, depth, filters):
    """Two unlimited dimensions give the version 2 B-tree chunk index
    (records of type 10, or 11 with filters), at depths 0 to 2, with
    chunks never written."""
    data = (np.arange(math.prod(shape)) % 1000).astype("<i2").reshape(shape)
    path = tmp_path / "x.h5"
    with h5py.File(path, "w", libver=libver) as h5:
        d = h5.create_dataset("d", shape=shape, dtype="<i2", chunks=chunks,
                              maxshape=(None, None), fillvalue=9,
                              compression="gzip" if filters else None)
        d[:, :shape[1] // 2] = data[:, :shape[1] // 2]
        d[:shape[0] // 3] = data[:shape[0] // 3]
        want = d[()]
    d = hdf5.open_file(str(path)).dataset("d")
    assert d._index == "btree2"
    depths = []
    real = hdf5._BTree2.__init__

    def spy(self, *args):
        real(self, *args)
        depths.append(self.depth)

    monkeypatch.setattr(hdf5._BTree2, "__init__", spy)
    np.testing.assert_array_equal(d.read(), want)
    assert depths == [depth]
    assert (want == 9).any()
    assert _same_file(path) == 1


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("libver", ["earliest", "latest"])
def test_lzf_reads_as_h5py_reads_it(tmp_path, libver, shuffle):
    """h5py's LZF filter (32000); a chunk of noise that LZF cannot shrink
    is stored as it is, its filter mask bit set."""
    rng = np.random.default_rng(32000)
    smooth = (np.arange(20000) // 7 % 900).astype("<i2")
    noise = rng.integers(0, 2 ** 63, 700, dtype="<i8")
    path = tmp_path / "x.h5"
    with h5py.File(path, "w", libver=libver) as h5:
        h5.create_dataset("smooth", data=smooth, chunks=(3000,),
                          compression="lzf", shuffle=shuffle)
        h5.create_dataset("noise", data=noise, chunks=(100,),
                          compression="lzf", shuffle=shuffle)
        h5.create_dataset("events", data=_events_for_lzf(rng),
                          compression="lzf", shuffle=shuffle)
    root = hdf5.open_file(str(path))
    np.testing.assert_array_equal(root.dataset("smooth").read(), smooth)
    np.testing.assert_array_equal(root.dataset("noise").read(), noise)
    assert _same_file(path) == 3


def _events_for_lzf(rng):
    ev = np.zeros(500, dtype=TOMBO_EVENTS)
    ev["norm_mean"] = rng.normal(0, 1, 500)
    ev["start"] = np.arange(500) * 9
    ev["length"] = 9
    ev["base"] = rng.choice(list(b"ACGT"), 500).astype("u1").view("S1")
    return ev


def test_lzf_errors_raise():
    with pytest.raises(ValueError, match="LZF: a back-reference before"):
        hdf5._unlzf(b"\x00a\x20\x05", "x")
    with pytest.raises(ValueError, match="LZF: a literal run past"):
        hdf5._unlzf(b"\x05ab", "x")
    assert hdf5._unlzf(b"\x00a\xe0\x03\x00", "x") == b"a" * 13


def _make_fixtures():
    spec = importlib.util.spec_from_file_location(
        "make_fixtures", os.path.join(FIXTURES, "make_fixtures.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("libver", ("earliest",) + NEW_FORMATS)
def test_tombo_like_reads_as_the_jax_reader_reads_it(tmp_path, libver):
    """The MinKNOW- and tombo-like layout of the fixtures (``Signal`` at
    maxshape (None,), tombo's ten ``Alignment`` attributes, 40 of
    ``tracking_id``) in each file format, with ten links under
    ``Analyses`` in the newer ones, read field for field and dtype for
    dtype as the JAX package's reader reads it."""
    fixtures = _make_fixtures()
    path = tmp_path / "x.fast5"
    rng = np.random.default_rng(11)
    if libver == "earliest":
        fixtures.write_tombo_like(str(path), rng)
    else:
        fixtures.write_tombo_latest(str(path), rng, libver)
    want = _jax_read(path)
    assert want.read_id == "0a1b2c3d-tombo-like"
    _same_read(fast5.read_resquiggled_fast5(str(path)), want)
    assert _same_file(path) > 10
    root = hdf5.open_file(str(path))
    dense = [root.group("UniqueGlobalKey/tracking_id").attrs._dense,
             root.group(STRAND + "/Alignment").attrs._dense,
             root.group("Analyses")._dense_links()]
    assert [x is not None for x in dense] == [libver != "earliest"] * 3
    assert root.dataset("Raw/Reads/Read_1234/Signal")._index == \
        {"earliest": "btree", "v108": "btree"}.get(libver, "earray")


def _new_structures_file(path):
    """One file of every new structure: dense links (64: an indirect heap
    root, a B-tree of depth 1), dense attributes, an extensible array with
    secondary and paged data blocks."""
    _signal(path, "latest", 132130, 1, False,
            [(10, 131070), (131100, 132089)])
    with h5py.File(path, "a", libver="latest") as h5:
        g = h5.create_group("g")
        for i in range(64):
            g.create_group(f"member_{i:02d}")
        for i in range(40):
            g.attrs[f"a{i}"] = np.int64(i)


@pytest.mark.parametrize("what", [
    "BTHD", "BTIN", "BTLF", "FRHP", "FHIB", "FHDB", "EAHD", "EAIB", "EASB",
    "EADB", "EADB page"])
def test_corrupt_checksums_raise(tmp_path, monkeypatch, what):
    """A byte flipped inside each checksummed structure (in a field the
    reader does not use before the checksum) raises a ValueError."""
    path = tmp_path / "x.h5"
    _new_structures_file(path)
    regions = []
    real = hdf5._File.checksum

    def spy(self, start, end, label):
        regions.append((self.buf[start:start + 4], label, start, end))
        return real(self, start, end, label)

    with monkeypatch.context() as m:
        m.setattr(hdf5._File, "checksum", spy)
        _read_all(path)
    raw = bytearray(path.read_bytes())
    if what == "FHDB":
        at = raw.index(b"FHDB")
        start, end = at, at + 512  # the heap's starting block size
    elif what == "EADB page":
        start, end = next((s, e) for _, label, s, e in regions
                          if label.endswith("'s page"))
    else:
        start, end = next((s, e) for sig, _, s, e in regions
                          if sig == what.encode())
    raw[start + (end - start) * 2 // 3] ^= 0x40
    path.write_bytes(bytes(raw))
    with pytest.raises(ValueError, match="checksum mismatch"):
        _read_all(path)


def test_a_heap_with_a_filter_pipeline_is_refused(tmp_path):
    """A fractal heap whose I/O filter length is set (rewritten in place,
    with the filtered root block's size, a filter mask and a byte of
    pipeline after the header's fields, and its checksum after them)."""
    path = tmp_path / "x.h5"
    with h5py.File(path, "w", libver="latest") as h5:
        for i in range(10):
            h5.attrs[f"a{i}"] = i
    raw = bytearray(path.read_bytes())
    at = raw.index(b"FRHP")
    raw[at + 7] = 1
    end = at + 14 + 10 * 8 + 2 * 8 + 8 + 2 * 8 + 8 + 8 + 4 + 1
    struct.pack_into("<I", raw, end, hdf5.lookup3(bytes(raw[at:end])))
    path.write_bytes(bytes(raw))
    with pytest.raises(NotImplementedError, match="fractal heap with an I/O "
                       "filter pipeline"):
        hdf5.open_file(str(path)).attrs["a1"]


# --------------------------------------------------------------------------
# the committed fixtures


@pytest.mark.parametrize("name", FIXTURE_FILES)
def test_fixtures_read_as_expected(name):
    expected = np.load(os.path.join(FIXTURES, "expected.npz"))
    read = fast5.read_resquiggled_fast5(os.path.join(FIXTURES,
                                                     f"{name}.fast5"))
    if f"{name}.none" in expected.files:
        assert read is None
        return
    for f in dataclasses.fields(read):
        got, want = np.asarray(getattr(read, f.name)), expected[
            f"{name}.{f.name}"]
        assert got.dtype == want.dtype, f.name
        np.testing.assert_array_equal(got, want, err_msg=f.name)


@pytest.mark.parametrize("name", FIXTURE_FILES)
def test_expected_npz_is_the_jax_readers_reading(name):
    expected = np.load(os.path.join(FIXTURES, "expected.npz"))
    path = os.path.join(FIXTURES, f"{name}.fast5")
    want = _jax_read(path)
    if want is None:
        assert f"{name}.none" in expected.files
        return
    assert sorted(k for k in expected.files if k.startswith(name + ".")) == \
        sorted(f"{name}.{f.name}" for f in dataclasses.fields(want))
    for f in dataclasses.fields(want):
        v = np.asarray(getattr(want, f.name))
        assert v.dtype == expected[f"{name}.{f.name}"].dtype
        np.testing.assert_array_equal(v, expected[f"{name}.{f.name}"])
    _same_read(fast5.read_resquiggled_fast5(path), want)


@pytest.mark.parametrize("name", FIXTURE_FILES)
def test_fixtures_read_through_the_port_as_through_h5py(name):
    assert _same_file(os.path.join(FIXTURES, f"{name}.fast5")) > 5


def test_fixtures_are_small():
    assert sum(os.path.getsize(os.path.join(FIXTURES, n))
               for n in os.listdir(FIXTURES)) < 300 * 1024


# --------------------------------------------------------------------------
# the writer


def _synthetic_kwargs(seed=3, bases=250):
    rng = np.random.default_rng(seed)
    seq = "".join(np.array(list("ACGT"))[rng.integers(0, 4, bases)])
    lengths = rng.integers(3, 22, size=bases)
    starts = np.concatenate([[0], np.cumsum(lengths)[:-1]])
    raw = rng.integers(380, 920, size=int(lengths.sum()) + 7).astype(np.int16)
    return dict(read_id="w-read", raw_signal=raw, event_starts_rel=starts,
                event_lengths=lengths, seq=seq, mapped_chrom="chr9",
                mapped_start=321, mapped_strand="-", read_start_rel_to_raw=4,
                offset=-3.5)


def test_write_synthetic_fast5_reads_as_the_jax_writers_file(tmp_path):
    kw = _synthetic_kwargs()
    fast5.write_synthetic_fast5(str(tmp_path / "port.fast5"), **kw)
    jax_fast5.write_synthetic_fast5(str(tmp_path / "jax.fast5"), **kw)
    want = _jax_read(tmp_path / "jax.fast5")
    _same_read(_jax_read(tmp_path / "port.fast5"), want)
    _same_read(fast5.read_resquiggled_fast5(str(tmp_path / "port.fast5")),
               want)
    _same_read(fast5.synthetic_read(**kw), want)
    with h5py.File(tmp_path / "port.fast5", "r") as a, \
            h5py.File(tmp_path / "jax.fast5", "r") as b:
        names = []
        a.visit(names.append)
        other = []
        b.visit(other.append)
        assert names == other
        for name in names:
            assert type(a[name]) is type(b[name])
            assert sorted(a[name].attrs) == sorted(b[name].attrs)
            for key in a[name].attrs:
                _same(a[name].attrs[key], b[name].attrs[key])
            if isinstance(b[name], h5py.Dataset):
                _same(a[name][()], b[name][()])
    assert _same_file(tmp_path / "port.fast5") == 11


def test_writer_tree_reads_back_through_h5py(tmp_path):
    rng = np.random.default_rng(8)
    ev = np.zeros(40, dtype=TOMBO_EVENTS)
    ev["norm_mean"] = rng.normal(0, 1, 40)
    ev["start"] = np.arange(40)
    ev["base"] = b"G"
    tree = {"ints": {t: _values(rng, t, 50) for t in
                     ("<i1", "<u2", ">i4", "<i8", "<u8")},
            "floats": {"f4": _values(rng, "<f4", 7), "f8": np.float64(2.25),
                       "be": _values(rng, ">f8", 5)},
            "strings": np.array([b"a", b"bcd", b""]),
            "Events": ev, "empty": {}, "nothing": np.zeros(0, "<i2"),
            "wide": {f"m{i:03d}": np.arange(i % 5, dtype="<i2")
                     for i in range(100)}}
    attrs = {"/": {"version": "2.0", "count": 3},
             "Events": {"read_start_rel_to_raw": np.int64(-2),
                        "scale": np.float64(0.5)},
             "wide/m007": {"v": np.arange(3, dtype="<u4")},
             "empty": {"text": "méthylé", "raw": b"\x01\x02"}}
    path = tmp_path / "w.h5"
    hdf5.write_file(str(path), tree, attrs)
    with h5py.File(path, "r") as h5:
        for t, v in tree["ints"].items():
            _same(h5["ints"][t][()], v)
        _same(h5["floats/f4"][()], tree["floats"]["f4"])
        assert h5["floats/f8"][()] == 2.25 and h5["floats/f8"].shape == ()
        _same(h5["floats/be"][()], tree["floats"]["be"])
        _same(h5["strings"][()], tree["strings"])
        _same(h5["Events"][()], ev)
        assert list(h5["empty"]) == [] and h5["nothing"].shape == (0,)
        assert list(h5["wide"]) == sorted(tree["wide"])
        assert h5.attrs["version"] == np.bytes_(b"2.0")
        assert h5.attrs["count"] == 3
        assert h5["Events"].attrs["read_start_rel_to_raw"] == -2
        _same(h5["wide/m007"].attrs["v"], np.arange(3, dtype="<u4"))
        assert h5["empty"].attrs["text"] == np.bytes_("méthylé".encode())
    assert _same_file(path) > 100


# --------------------------------------------------------------------------
# what the reader refuses, and broken files


def _plain_file(path, libver="earliest", **kw):
    with h5py.File(path, "w", libver=libver) as h5:
        h5.create_dataset("d", data=np.arange(1000, dtype="<i2"),
                          chunks=(100,), **kw)
    return path


def _message(path, name, mtype):
    """The file offset of the first message ``mtype`` in the header of
    ``name``."""
    obj = hdf5.open_file(str(path)).dataset(name)
    return next(p for t, _f, p, _s in obj._msgs if t == mtype)


def test_dense_attribute_storage_is_refused(tmp_path):
    """Dense attribute storage (ten attributes in the latest format) reads
    as h5py reads it."""
    path = tmp_path / "x.h5"
    with h5py.File(path, "w", libver="latest") as h5:
        g = h5.create_group("g")
        for i in range(10):
            g.attrs[f"a{i}"] = i
    g = hdf5.open_file(str(path)).group("g")
    assert g.attrs._dense is not None
    assert g.attrs["a1"] == 1
    assert _same_file(path) == 1


def test_dense_link_storage_is_refused(tmp_path):
    """Dense link storage (20 links in the latest format) reads as h5py
    reads it."""
    path = tmp_path / "x.h5"
    with h5py.File(path, "w", libver="latest") as h5:
        for i in range(20):
            h5.create_group(f"g{i}")
    root = hdf5.open_file(str(path))
    assert root._dense_links() is not None
    assert root.members() == sorted(f"g{i}" for i in range(20))
    assert _same_file(path) == 20


@pytest.mark.parametrize("fid,match", [
    (hdf5.VBZ_FILTER, "VBZ.*32020.*compress_fast5 --compression gzip"),
    (307, "filter 307")])
def test_other_filters_are_refused(tmp_path, fid, match):
    """A gzip pipeline whose filter id is rewritten in place."""
    path = _plain_file(tmp_path / "x.h5", compression="gzip")
    at = _message(path, "d", 0x0B)
    raw = bytearray(path.read_bytes())
    assert raw[at] == 1 and struct.unpack_from("<H", raw, at + 8)[0] == 1
    struct.pack_into("<H", raw, at + 8, fid)
    path.write_bytes(bytes(raw))
    d = hdf5.open_file(str(path)).dataset("d")
    with pytest.raises(NotImplementedError, match=match):
        d.read()


@pytest.mark.parametrize("maxshape,match", [
    ((None,), "extensible-array chunk index"),
    ((None, None), "version 2 B-tree chunk index")])
def test_other_chunk_indexes_are_refused(tmp_path, maxshape, match):
    """The layout version 4 chunk indexes of unlimited datasets (``match``
    names which) read as h5py reads them."""
    path = tmp_path / "x.h5"
    shape = (10,) * len(maxshape)
    data = np.arange(10 ** len(shape), dtype="<f8").reshape(shape)
    with h5py.File(path, "w", libver="latest") as h5:
        h5.create_dataset("d", data=data, chunks=(3,) * len(shape),
                          maxshape=maxshape)
    d = hdf5.open_file(str(path)).dataset("d")
    assert d._index == {"extensible-array chunk index": "earray",
                        "version 2 B-tree chunk index": "btree2"}[match]
    np.testing.assert_array_equal(d.read(), data)
    assert _same_file(path) == 1


def test_external_and_virtual_storage_are_refused(tmp_path):
    (tmp_path / "raw.bin").write_bytes(bytes(80))
    path = tmp_path / "x.h5"
    with h5py.File(path, "w", libver="latest") as h5:
        h5.create_dataset("ext", shape=(10,), dtype="<f8",
                          external=[(str(tmp_path / "raw.bin"), 0, 80)])
        h5.create_dataset("src", data=np.arange(4.0))
        layout = h5py.VirtualLayout(shape=(4,), dtype="<f8")
        layout[:] = h5py.VirtualSource(h5["src"])
        h5.create_virtual_dataset("virt", layout)
        h5["soft"] = h5py.SoftLink("/src")
    root = hdf5.open_file(str(path))
    with pytest.raises(NotImplementedError, match="external storage"):
        root.dataset("ext")
    with pytest.raises(NotImplementedError, match="virtual storage"):
        root.dataset("virt")
    with pytest.raises(NotImplementedError, match="soft link"):
        root.dataset("soft")
    np.testing.assert_array_equal(root.dataset("src").read(), np.arange(4.0))


def test_a_truncated_file_raises(tmp_path):
    path = _plain_file(tmp_path / "x.h5")
    raw = path.read_bytes()
    path.write_bytes(raw[:len(raw) // 2])
    with pytest.raises(ValueError, match="cut short"):
        hdf5.open_file(str(path))
    with pytest.raises(ValueError, match="cut short"):
        fast5.read_resquiggled_fast5(str(path))


def test_a_bad_signature_raises(tmp_path):
    path = _plain_file(tmp_path / "x.h5")
    raw = bytearray(path.read_bytes())
    (tmp_path / "text.fast5").write_bytes(b"not an hdf5 file")
    with pytest.raises(ValueError, match="not an HDF5 file"):
        fast5.read_resquiggled_fast5(str(tmp_path / "text.fast5"))
    d = hdf5.open_file(str(path)).dataset("d")
    tree = d._addr_data
    assert raw[tree:tree + 4] == b"TREE"
    raw[tree:tree + 4] = b"EERT"
    path.write_bytes(bytes(raw))
    with pytest.raises(ValueError, match=r"/d's chunk B-tree node at byte "
                       rf"{tree} has the signature b'EERT', not b'TREE'"):
        hdf5.open_file(str(path)).dataset("d").read()
    raw[:8] = b"\x89HDX\r\n\x1a\n"
    path.write_bytes(bytes(raw))
    with pytest.raises(ValueError, match="not an HDF5 file"):
        hdf5.open_file(str(path))


def test_checksums_are_verified(tmp_path):
    path = _plain_file(tmp_path / "x.h5", libver="latest", fletcher32=True)
    at = _message(path, "d", 0x01)  # the dataspace, inside a checksummed header
    raw = bytearray(path.read_bytes())
    d = hdf5.open_file(str(path)).dataset("d")
    chunk = next(d._chunks(200))[1]
    raw[chunk + 3] ^= 0xFF
    bad_data = bytes(raw)
    raw[chunk + 3] ^= 0xFF
    raw[at + 8] ^= 0x01
    (tmp_path / "header.h5").write_bytes(bytes(raw))
    path.write_bytes(bad_data)
    with pytest.raises(ValueError, match="fletcher32 checksum mismatch"):
        hdf5.open_file(str(path)).dataset("d").read()
    with pytest.raises(ValueError, match="/d at bytes .*checksum mismatch"):
        hdf5.open_file(str(tmp_path / "header.h5")).dataset("d")


def test_lookup3_known_values():
    # lookup3.c's driver5 values
    assert hdf5.lookup3(b"") == 0xDEADBEEF
    assert hdf5.lookup3(b"", 0xDEADBEEF) == 0xBD5B7DDE
    assert hdf5.lookup3(b"Four score and seven years ago") == 0x17770551
    assert hdf5.lookup3(b"Four score and seven years ago", 1) == 0xCD628161


# --------------------------------------------------------------------------
# the fast5 reader's failures, as the JAX package's reader fails


def _defective(path, defect):
    fast5.write_synthetic_fast5(str(path), **_synthetic_kwargs())
    if defect == "none":
        return
    with h5py.File(path, "a") as h5:
        if defect == "no_raw":
            del h5["Raw/Reads/Read_0/Signal"]
        elif defect == "no_reads":
            del h5["Raw/Reads/Read_0"]
        elif defect == "no_read_id":
            del h5["Raw/Reads/Read_0"].attrs["read_id"]
        elif defect == "no_alignment":
            del h5[STRAND + "/Alignment"]
        elif defect == "no_analyses":
            del h5["Analyses"]
        elif defect == "no_events":
            del h5[STRAND + "/Events"]
        elif defect == "no_rel":
            del h5[STRAND + "/Events"].attrs["read_start_rel_to_raw"]
        elif defect == "no_mapped_chrom":
            del h5[STRAND + "/Alignment"].attrs["mapped_chrom"]
        elif defect == "no_channel":
            del h5["UniqueGlobalKey/channel_id"]


@pytest.mark.parametrize("defect,same_message", [
    ("none", True), ("no_raw", True), ("no_reads", True),
    ("no_read_id", True), ("no_alignment", True), ("no_analyses", True),
    ("no_events", True), ("no_rel", True), ("no_mapped_chrom", False),
    ("no_channel", False)])
def test_fast5_failures_match_the_jax_reader(tmp_path, defect, same_message):
    path = tmp_path / "x.fast5"
    _defective(path, defect)
    try:
        want = _jax_read(path)
    except Exception as e:  # noqa: BLE001 - the reference's type is the spec
        with pytest.raises(type(e)) as got:
            fast5.read_resquiggled_fast5(str(path))
        assert type(got.value) is type(e)
        if same_message:
            assert str(got.value) == str(e)
        return
    _same_read(fast5.read_resquiggled_fast5(str(path)), want)
