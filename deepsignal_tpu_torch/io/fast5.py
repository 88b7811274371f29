"""Single-read fast5 access, tombo-resquiggled layout (port of
deepsignal_tpu/io/fast5.py).

Layout (SURVEY.md §2.5; extract_features.py:27,35-140,193-208):

- ``Raw/Reads/Read_<n>/Signal``: raw DAC values; attr ``read_id``
- ``Analyses/<corrected_group>/<basecall_subgroup>/Events``: fields ``start``,
  ``length``, ``base``; attr ``read_start_rel_to_raw``
- ``Analyses/<corrected_group>/<basecall_subgroup>/Alignment``: attrs
  ``mapped_strand``, ``mapped_chrom``, ``mapped_start``
- ``UniqueGlobalKey/channel_id``: attrs ``digitisation``, ``range``, ``offset``

Attributes are decoded whether they are stored as bytes or as str
(extract_features.py:84-102).

Files are read and written by the package's own HDF5 code
(``io/hdf5.py``), so fast5 input needs no h5py.
"""

from __future__ import annotations

import dataclasses
import fnmatch
import os
from typing import Optional

import numpy as np

from . import hdf5

READS_GROUP = "Raw/Reads"


def _decode_attr(value) -> str:
    """bytes/str defensive decode (extract_features.py:84-102)."""
    if isinstance(value, bytes):
        return value.decode("utf-8")
    return str(value)


@dataclasses.dataclass
class ResquiggledRead:
    """Everything the featurizer needs from one fast5 file."""

    read_id: str
    raw_signal: np.ndarray       # raw DAC values (int)
    event_starts: np.ndarray     # absolute start index into raw_signal [n]
    event_lengths: np.ndarray    # signal points per base [n]
    seq: str                     # basecalled/aligned sequence, one char/event
    read_strand: str             # 't' (template) or 'c' (complement)
    align_strand: str            # '+' or '-'
    chrom: str
    chrom_start: int
    scaling: float               # range / digitisation
    offset: float


def get_fast5s(fast5_dir: str, is_recursive: bool = True) -> list:
    """Discover *.fast5 files (process_utils.py:146-159)."""
    fast5_dir = os.path.abspath(fast5_dir)
    fast5s = []
    if is_recursive:
        for root, _dirnames, filenames in os.walk(fast5_dir):
            for filename in fnmatch.filter(filenames, "*.fast5"):
                fast5s.append(os.path.join(root, filename))
    else:
        for name in os.listdir(fast5_dir):
            if name.endswith(".fast5"):
                fast5s.append("/".join([fast5_dir, name]))
    return fast5s


def read_resquiggled_fast5(fast5_path: str,
                           corrected_group: str = "RawGenomeCorrected_000",
                           basecall_subgroup: str = "BaseCalled_template",
                           ) -> Optional[ResquiggledRead]:
    """Read one tombo-corrected fast5 in a single read of the file, through
    ``io/hdf5.py``; the reference opens each file three times.  Returns
    None when the corrected Alignment group is missing (the empty tuple of
    extract_features.py:136-137); raises on a structural error so that the
    caller can count it (extract_features.py:281-283), with the exception
    types and messages of the JAX package's reader."""
    strand_path = "/".join(["Analyses", corrected_group, basecall_subgroup])
    root = hdf5.open_file(fast5_path)
    # raw signal + read id (extract_features.py:41-49, 108-118)
    try:
        reads = root.group(READS_GROUP)
        read_path = READS_GROUP + "/" + reads.members()[0]
        raw_signal = root.dataset(read_path + "/Signal").read()
    except Exception as e:
        raise RuntimeError(
            "Raw data is not stored in Raw/Reads/Read_[read#]") from e
    try:
        read_id = _decode_attr(root.group(read_path).attrs["read_id"])
    except KeyError as e:
        raise KeyError("no read_id attribute on " + read_path) from e

    try:
        alignment = root.group(strand_path + "/Alignment").attrs
    except KeyError:
        return None

    # events (extract_features.py:51-72)
    try:
        events = root.dataset(strand_path + "/Events")
    except KeyError as e:
        raise RuntimeError("events not found") from e
    ev = events.read()
    try:
        rel = events.attrs["read_start_rel_to_raw"]
    except KeyError as e:
        raise KeyError("no read_start_rel_to_raw in event attributes") \
            from e
    starts = np.asarray(ev["start"], dtype=np.int64) + int(rel)
    lengths = np.asarray(ev["length"], dtype=np.int64)
    bases = ev["base"]
    if bases.dtype.kind == "S":
        # fixed-width byte strings: the buffer is the concatenated seq
        seq = bases.tobytes().decode("utf-8") \
            if bases.dtype.itemsize == 1 \
            else b"".join(bases.tolist()).decode("utf-8")
    else:
        seq = "".join(_decode_attr(b) for b in bases)

    # alignment attrs (extract_features.py:75-105)
    align_strand = _decode_attr(alignment["mapped_strand"])
    chrom = _decode_attr(alignment["mapped_chrom"])
    chrom_start = int(alignment["mapped_start"])
    read_strand = "t" if basecall_subgroup.endswith("template") else "c"

    # channel scaling (extract_features.py:193-208)
    channel = root.group("UniqueGlobalKey/channel_id").attrs
    digi = float(channel["digitisation"])
    parange = float(channel["range"])
    offset = float(channel["offset"])

    return ResquiggledRead(
        read_id=read_id, raw_signal=raw_signal, event_starts=starts,
        event_lengths=lengths, seq=seq, read_strand=read_strand,
        align_strand=align_strand, chrom=chrom, chrom_start=chrom_start,
        scaling=parange / digi, offset=offset)


def synthetic_read(read_id: str, raw_signal: np.ndarray,
                   event_starts_rel: np.ndarray, event_lengths: np.ndarray,
                   seq: str, mapped_chrom: str, mapped_start: int,
                   mapped_strand: str, read_start_rel_to_raw: int = 0,
                   digitisation: float = 8192.0, prange: float = 1402.882,
                   offset: float = 6.0,
                   basecall_subgroup: str = "BaseCalled_template"
                   ) -> ResquiggledRead:
    """The read that ``read_resquiggled_fast5`` returns for the file that
    ``write_synthetic_fast5`` writes with the same arguments, made in
    memory, with no file."""
    return ResquiggledRead(
        read_id=read_id,
        raw_signal=np.asarray(raw_signal, dtype=np.int16),
        event_starts=(np.asarray(event_starts_rel, dtype=np.int64)
                      + int(read_start_rel_to_raw)),
        event_lengths=np.asarray(event_lengths, dtype=np.int64), seq=seq,
        read_strand="t" if basecall_subgroup.endswith("template") else "c",
        align_strand=mapped_strand, chrom=mapped_chrom,
        chrom_start=int(mapped_start),
        scaling=float(prange) / float(digitisation), offset=float(offset))


def write_synthetic_fast5(path: str, read_id: str, raw_signal: np.ndarray,
                          event_starts_rel: np.ndarray,
                          event_lengths: np.ndarray, seq: str,
                          mapped_chrom: str, mapped_start: int,
                          mapped_strand: str,
                          read_start_rel_to_raw: int = 0,
                          digitisation: float = 8192.0,
                          prange: float = 1402.882,
                          offset: float = 6.0,
                          corrected_group: str = "RawGenomeCorrected_000",
                          basecall_subgroup: str = "BaseCalled_template") -> None:
    """Write a minimal tombo-layout fast5 (a test fixture; layout per
    SURVEY.md §2.5).  ``event_starts_rel`` are relative to
    ``read_start_rel_to_raw``."""
    n = len(seq)
    ev = np.empty(n, dtype=[("start", "<i8"), ("length", "<i8"),
                            ("base", "S1")])
    ev["start"] = np.asarray(event_starts_rel, dtype=np.int64)
    ev["length"] = np.asarray(event_lengths, dtype=np.int64)
    ev["base"] = np.array([s.encode() for s in seq], dtype="S1")
    strand = f"Analyses/{corrected_group}/{basecall_subgroup}"
    tree = {"Raw": {"Reads": {"Read_0": {
                "Signal": np.asarray(raw_signal, dtype=np.int16)}}},
            "Analyses": {corrected_group: {basecall_subgroup: {
                "Events": ev, "Alignment": {}}}},
            "UniqueGlobalKey": {"channel_id": {}}}
    hdf5.write_file(path, tree, attrs={
        f"{READS_GROUP}/Read_0": {"read_id": np.bytes_(read_id.encode())},
        f"{strand}/Events": {
            "read_start_rel_to_raw": np.int64(read_start_rel_to_raw)},
        f"{strand}/Alignment": {
            "mapped_strand": np.bytes_(mapped_strand.encode()),
            "mapped_chrom": np.bytes_(mapped_chrom.encode()),
            "mapped_start": np.int64(mapped_start)},
        "UniqueGlobalKey/channel_id": {
            "digitisation": np.float64(digitisation),
            "range": np.float64(prange), "offset": np.float64(offset)}})
