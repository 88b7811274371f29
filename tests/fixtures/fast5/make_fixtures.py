"""Write the fast5 fixtures of this directory with h5py, and beside them
``expected.npz``: what the JAX package's ``read_resquiggled_fast5`` returns
for each file.  Run from the root of the repository after an intended
change only:

    python tests/fixtures/fast5/make_fixtures.py

The files (about 250 bases each):

- ``synthetic.fast5``: ``write_synthetic_fast5``'s layout, written by the
  JAX package's own writer;
- ``tombo_like.fast5``: a MinKNOW- and tombo-like file: ``Signal`` chunked
  with gzip and shuffle at maxshape ``(None,)``, tombo's five-field
  ``Events`` (gzip), variable-length string ``read_id``,
  ``mapped_chrom`` and ``mapped_strand``, ``Alignment`` with tombo's ten
  attributes, a ``tracking_id`` with many attributes, a basecaller's
  ``Fastq`` and a second corrected group;
- ``latest.fast5``: ``libver="latest"`` (superblock 3, version 2 object
  headers, link messages, a layout version 4 fixed-array chunk index), at
  most 8 attributes an object;
- ``no_alignment.fast5``: no ``Alignment`` group (the reader returns
  None).
"""

import dataclasses
import os
import sys

import h5py
import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(HERE))))

from deepsignal_tpu.io.fast5 import (read_resquiggled_fast5,  # noqa: E402
                                     write_synthetic_fast5)

FILES = ("synthetic", "tombo_like", "latest", "no_alignment")
FIELDS = ("read_id", "raw_signal", "event_starts", "event_lengths", "seq",
          "read_strand", "align_strand", "chrom", "chrom_start", "scaling",
          "offset")
BASES = 250
STRAND = "Analyses/RawGenomeCorrected_000/BaseCalled_template"


def _read(rng, bases=BASES):
    seq = "".join(np.array(list("ACGT"))[rng.integers(0, 4, bases)])
    lengths = rng.integers(3, 22, size=bases)
    starts = np.concatenate([[0], np.cumsum(lengths)[:-1]])
    raw = rng.integers(380, 920, size=int(lengths.sum()) + 7).astype(np.int16)
    return seq, lengths, starts, raw


def _tombo_events(rng, seq, lengths, starts):
    ev = np.empty(len(seq), dtype=[("norm_mean", "<f8"), ("norm_stdev", "<f8"),
                                   ("start", "<u4"), ("length", "<u4"),
                                   ("base", "S1")])
    ev["norm_mean"] = rng.normal(0, 1, len(seq))
    ev["norm_stdev"] = np.abs(rng.normal(0, 0.2, len(seq)))
    ev["start"], ev["length"] = starts, lengths
    ev["base"] = np.array([s.encode() for s in seq], dtype="S1")
    return ev


def _channel(h5, extra: bool):
    ch = h5.create_group("UniqueGlobalKey/channel_id")
    ch.attrs["digitisation"] = np.float64(8192.0)
    ch.attrs["range"] = np.float64(1441.1)
    ch.attrs["offset"] = np.float64(13.0)
    if extra:
        ch.attrs["sampling_rate"] = np.float64(4000.0)
        ch.attrs["channel_number"] = np.bytes_(b"139")


def _alignment(group, chrom, start, strand, n, ten: bool):
    aln = group.create_group("Alignment")
    aln.attrs["mapped_start"] = np.int64(start)
    aln.attrs["mapped_end"] = np.int64(start + n)
    aln.attrs["mapped_strand"] = strand
    aln.attrs["mapped_chrom"] = chrom          # a str: variable length
    if ten:
        for name, v in (("clipped_bases_start", 2), ("clipped_bases_end", 3),
                        ("num_insertions", 4), ("num_deletions", 5),
                        ("num_matches", n - 9), ("num_mismatches", 7)):
            aln.attrs[name] = np.int64(v)


def write_synthetic(path, rng):
    seq, lengths, starts, raw = _read(rng)
    write_synthetic_fast5(path, "synthetic-read", raw, starts, lengths, seq,
                          "chr2", 1234, "-", read_start_rel_to_raw=4)


def write_tombo_like(path, rng):
    seq, lengths, starts, raw = _read(rng)
    with h5py.File(path, "w") as h5:
        h5.attrs["file_version"] = np.bytes_(b"2.0")
        rg = h5.create_group("Raw/Reads/Read_1234")
        rg.create_dataset("Signal", data=raw, chunks=(1024,), maxshape=(None,),
                          compression="gzip", shuffle=True)
        rg.attrs["read_id"] = "0a1b2c3d-tombo-like"   # a str: variable length
        rg.attrs["read_number"] = np.int32(1234)
        rg.attrs["start_time"] = np.uint64(123456789)
        rg.attrs["duration"] = np.uint32(len(raw))
        rg.attrs["start_mux"] = np.uint8(2)
        rg.attrs["median_before"] = np.float64(231.5)
        _channel(h5, extra=True)
        tr = h5.create_group("UniqueGlobalKey/tracking_id")
        for i in range(40):
            tr.attrs[f"key_{i:02d}"] = np.bytes_(f"value-{i}".encode() * 3)
        ctx = h5.create_group("UniqueGlobalKey/context_tags")
        ctx.attrs["experiment_type"] = np.bytes_(b"genomic_dna")
        bc = h5.create_group("Analyses/Basecall_1D_000/BaseCalled_template")
        bc.create_dataset("Fastq", data=f"@read\n{seq}\n+\n{'I' * len(seq)}\n")
        h5["Analyses/Basecall_1D_000"].attrs["name"] = "basecaller"
        cg = h5.create_group("Analyses/RawGenomeCorrected_000")
        cg.attrs["basecall_group"] = "Basecall_1D_000"
        cg.attrs["tombo_version"] = "1.5.1"
        tg = cg.create_group("BaseCalled_template")
        for name, v in (("lower_lim", -5.0), ("upper_lim", 5.0),
                        ("scale", 20.5), ("shift", 90.25),
                        ("signal_match_score", 1.1)):
            tg.attrs[name] = np.float64(v)
        tg.attrs["status"] = "success"
        tg.attrs["rna"] = False
        ev = tg.create_dataset("Events", data=_tombo_events(rng, seq, lengths,
                                                            starts),
                               compression="gzip")
        ev.attrs["read_start_rel_to_raw"] = np.int64(7)
        _alignment(tg, "chr3", 5000, "+", len(seq), ten=True)
        # a second corrected group, with other values: never read
        og = h5.create_group("Analyses/RawGenomeCorrected_001/"
                             "BaseCalled_template")
        other = _tombo_events(rng, seq[:100], lengths[:100], starts[:100])
        og.create_dataset("Events", data=other, compression="gzip")
        og["Events"].attrs["read_start_rel_to_raw"] = np.int64(0)
        _alignment(og, "chrX", 9, "-", 100, ten=True)


def write_latest(path, rng):
    seq, lengths, starts, raw = _read(rng)
    with h5py.File(path, "w", libver="latest") as h5:
        rg = h5.create_group("Raw/Reads/Read_7")
        rg.create_dataset("Signal", data=raw, chunks=(500,),
                          maxshape=(len(raw),), compression="gzip")
        rg.attrs["read_id"] = "latest-format-read"
        rg.attrs["read_number"] = np.int32(7)
        _channel(h5, extra=True)
        tr = h5.create_group("UniqueGlobalKey/tracking_id")
        for i in range(8):
            tr.attrs[f"key_{i}"] = f"value-{i}"
        tg = h5.create_group(STRAND)
        ev = tg.create_dataset("Events", data=_tombo_events(rng, seq, lengths,
                                                            starts))
        ev.attrs["read_start_rel_to_raw"] = np.int64(11)
        _alignment(tg, "chrM", 77, "-", len(seq), ten=False)


def write_no_alignment(path, rng):
    seq, lengths, starts, raw = _read(rng)
    write_synthetic_fast5(path, "unaligned-read", raw, starts, lengths, seq,
                          "chr1", 0, "+")
    with h5py.File(path, "a") as h5:
        del h5[STRAND + "/Alignment"]


def expected_arrays(paths: dict) -> dict:
    """The JAX reader's fields of each file, keyed "<file>.<field>"; a file
    it returns None for holds only "<file>.none"."""
    out = {}
    for name, path in paths.items():
        read = read_resquiggled_fast5(path)
        if read is None:
            out[f"{name}.none"] = np.array(True)
            continue
        for field in FIELDS:
            out[f"{name}.{field}"] = np.asarray(getattr(read, field))
    return out


def main():
    rng = np.random.default_rng(20261017)
    paths = {}
    for name, write in zip(FILES, (write_synthetic, write_tombo_like,
                                   write_latest, write_no_alignment)):
        paths[name] = os.path.join(HERE, f"{name}.fast5")
        write(paths[name], rng)
    np.savez(os.path.join(HERE, "expected.npz"), **expected_arrays(paths))
    for name, path in paths.items():
        print(f"{path}: {os.path.getsize(path)} bytes")


if __name__ == "__main__":
    main()
