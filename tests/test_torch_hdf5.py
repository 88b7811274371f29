"""The port's HDF5 reader and writer (``deepsignal_tpu_torch/io/hdf5.py``)
against h5py: files h5py writes over a grid of formats, layouts, filters,
types, attributes and group sizes read as h5py reads them; the writer's
files read by h5py as the written values; every refused feature raises an
error that names it; and the committed fast5 fixtures read as the JAX
package's reader reads them."""

import ctypes
import dataclasses
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
FIXTURE_FILES = ("synthetic", "tombo_like", "latest", "no_alignment")
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
            assert mine.members() == [
                obj.id.get_objname_by_idx(i).decode()
                for i in range(len(obj))]
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
    path = tmp_path / "x.h5"
    with h5py.File(path, "w", libver="latest") as h5:
        g = h5.create_group("g")
        for i in range(10):
            g.attrs[f"a{i}"] = i
    g = hdf5.open_file(str(path)).group("g")
    with pytest.raises(NotImplementedError, match="dense attribute storage"):
        g.attrs["a1"]


def test_dense_link_storage_is_refused(tmp_path):
    path = tmp_path / "x.h5"
    with h5py.File(path, "w", libver="latest") as h5:
        for i in range(20):
            h5.create_group(f"g{i}")
    with pytest.raises(NotImplementedError, match="dense link storage"):
        hdf5.open_file(str(path)).members()


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
    path = tmp_path / "x.h5"
    shape = (10,) * len(maxshape)
    with h5py.File(path, "w", libver="latest") as h5:
        h5.create_dataset("d", data=np.ones(shape), chunks=(3,) * len(shape),
                          maxshape=maxshape)
    with pytest.raises(NotImplementedError, match=match):
        hdf5.open_file(str(path)).dataset("d")


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
