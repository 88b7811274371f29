"""The one generator of the benchmark's traffic, driven by a traffic file's
parameters and ``--seed``.

Sites are grouped by read.  The sizes of the reads (CpG sites per read)
are a fixed set for given parameters: the quantiles of a log-normal law
(``reads.median``, ``reads.sigma``, cut at ``reads.max``), taken at evenly
spaced probabilities until they hold the rows asked for.  The seed only
orders them and draws everything else, so that every seed asks the
program for the same work.  Per-base signal counts are Poisson around
``signals_per_base``; means, deviations and the central signals are on the
MAD-normalised scale, on a grid of 6 decimals (the precision that
``extract`` writes), as the float32 values a TSV row of them parses to.
Labels are half positive.
"""

from __future__ import annotations

import statistics
import string

import numpy as np

MICRO = 1_000_000          # values are whole multiples of 1e-6
MAX_MICRO = 9_999_999      # |value| < 10: one digit before the point
CHROM_LEN = 248_956_422    # the longest human chromosome
CHROMS = [f"chr{i}" for i in range(1, 23)] + ["chrX"]


def rng_for(seed: int, salt: int) -> np.random.Generator:
    """A generator for one use (``salt``) of a seed of any size."""
    return np.random.default_rng([abs(int(seed)), int(seed < 0), salt])


def read_sizes(n_rows: int, reads: dict) -> np.ndarray:
    """The fixed multiset of sites per read that holds exactly ``n_rows``
    sites: log-normal quantiles at probabilities (i + 0.5) / n for the
    smallest n whose sum reaches ``n_rows``, the largest read cut to fit."""
    law = statistics.NormalDist(np.log(reads["median"]), reads["sigma"])
    n = max(1, int(n_rows / (reads["median"] * np.exp(reads["sigma"] ** 2
                                                       / 2))))
    while True:
        sizes = np.array([law.inv_cdf((i + 0.5) / n) for i in range(n)])
        sizes = np.clip(np.rint(np.exp(sizes)), 1, reads["max"]).astype(int)
        if sizes.sum() >= n_rows:
            break
        n += 1
    sizes[-1] -= sizes.sum() - n_rows
    sizes = sizes[sizes > 0]
    return sizes


def sampleinfo(rng: np.random.Generator, sizes: np.ndarray) -> list:
    """The first six columns of every row, read by read: chrom, pos,
    strand, pos_in_strand, read name (a UUID, as ONT names reads), read
    strand.  Sites of a read lie in order at CpG spacing."""
    rows = []
    hexd = np.array(list(string.hexdigits[:16]))
    for size in sizes:
        chrom = CHROMS[rng.integers(len(CHROMS))]
        strand = "+" if rng.integers(2) else "-"
        h = "".join(hexd[rng.integers(0, 16, 32)])
        name = f"{h[:8]}-{h[8:12]}-{h[12:16]}-{h[16:20]}-{h[20:]}"
        pos = int(rng.integers(0, CHROM_LEN // 2)) \
            + np.cumsum(1 + rng.geometric(1 / 80, size))
        for p in pos.tolist():
            pis = p if strand == "+" else CHROM_LEN - 1 - p
            rows.append(f"{chrom}\t{p}\t{strand}\t{pis}\t{name}\tt")
    return rows


def features(rng: np.random.Generator, n: int, kmer_len: int,
             signal_len: int, per_base: float, text: bool) -> dict:
    """Feature arrays of ``n`` sites: k-mer codes (A, C, G, T = 0-3) with
    the CpG at the centre, and means, stds, signal counts and central
    signals as the float32 values of their 6-decimal text; with ``text``
    the float columns also as integer micro-units (``*_micro``)."""
    k, s = kmer_len, signal_len
    kmer = rng.integers(0, 4, (n, k), dtype=np.int32)
    kmer[:, k // 2], kmer[:, k // 2 + 1] = 1, 2
    lens = np.clip(rng.poisson(per_base, (n, k)), 1, 99).astype(np.int32)
    f32 = np.float32
    means = rng.normal(0.0, 0.9, (n, k)) + rng.normal(0.0, 0.05, (n, k))
    stds = np.abs(rng.normal(0.25, 0.08, (n, k))) + 0.02
    # central signals: a level held for a Poisson dwell, plus noise; the
    # dwells of a row outlast its signals (mean 1.3 s + 8 dwells of ~9)
    dwell_n = int(1.3 * s / per_base) + 8
    dwell = 1 + rng.poisson(per_base - 1, (n, dwell_n))
    levels = rng.standard_normal((n, dwell_n), dtype=f32) * f32(0.9)
    idx = np.repeat(np.arange(n * dwell_n, dtype=np.int32), dwell.ravel())
    starts = np.concatenate([[0], np.cumsum(dwell.sum(axis=1))[:-1]])
    sig = levels.ravel()[idx[starts[:, None] + np.arange(s)]]
    sig += rng.standard_normal((n, s), dtype=f32) * f32(0.2)
    out = {"kmer": kmer, "lens": lens}
    for name, arr in (("means", means), ("stds", stds), ("signals", sig)):
        micro = np.clip(np.rint(arr * arr.dtype.type(MICRO)), -MAX_MICRO,
                        MAX_MICRO)
        if text:
            out[name + "_micro"] = micro.astype(np.int64)
        out[name] = (micro / MICRO).astype(np.float32)
    return out


def labels(rng: np.random.Generator, n: int) -> np.ndarray:
    """Exactly half of ``n`` labels positive (one more negative when odd),
    in a random order."""
    lab = np.zeros(n, dtype=np.int32)
    lab[: n // 2] = 1
    rng.shuffle(lab)
    return lab


def rows(seed: int, n_rows: int, cfg: dict, params: dict,
         text: bool = False) -> dict:
    """Every array of ``n_rows`` sites of the traffic, reads shuffled;
    ``text``: with the micro-units ``tsv_block`` writes."""
    rng = rng_for(seed, 1)
    sizes = read_sizes(n_rows, params["reads"])
    rng.shuffle(sizes)
    out = features(rng, n_rows, cfg["kmer_len"], cfg["cent_signals_len"],
                   params["signals_per_base"], text)
    out["sampleinfo"] = sampleinfo(rng, sizes)
    out["labels"] = labels(rng, n_rows)
    out["read_sizes"] = sizes
    return out


# -- text -----------------------------------------------------------------

_DIGITS = np.frombuffer(b"0123456789", dtype=np.uint8)


def _fixed6(micro: np.ndarray, sep: int) -> np.ndarray:
    """[n, m] micro-units -> [n, 10 m] bytes: an optional '-' (0 where
    absent), one digit, '.', six digits, and ``sep`` after each value but
    the last, which gets a tab."""
    n, m = micro.shape
    a = np.abs(micro)
    out = np.zeros((n, m, 10), dtype=np.uint8)
    out[..., 0] = np.where(micro < 0, ord("-"), 0)
    out[..., 1] = _DIGITS[a // MICRO]
    out[..., 2] = ord(".")
    for i in range(6):
        out[..., 3 + i] = _DIGITS[(a // 10 ** (5 - i)) % 10]
    out[..., 9] = sep
    out[:, -1, 9] = ord("\t")
    return out.reshape(n, 10 * m)


def _ints2(vals: np.ndarray) -> np.ndarray:
    """[n, m] integers 1-99 -> [n, 3 m] bytes, commas between, a tab
    after the last."""
    n, m = vals.shape
    out = np.zeros((n, m, 3), dtype=np.uint8)
    out[..., 0] = np.where(vals >= 10, _DIGITS[vals // 10], 0)
    out[..., 1] = _DIGITS[vals % 10]
    out[..., 2] = ord(",")
    out[:, -1, 2] = ord("\t")
    return out.reshape(n, 3 * m)


def _strings(texts: list) -> np.ndarray:
    """[n] ascii strings -> [n, width] bytes, zero-padded."""
    arr = np.array([t.encode("ascii") for t in texts])
    return arr.view(np.uint8).reshape(len(texts), arr.dtype.itemsize)


def tsv_block(data: dict) -> bytes:
    """The feature rows of ``data`` as ``extract`` writes them: sampleinfo,
    k-mer, means, stds, signal counts, central signals, label; the floats
    with 6 decimals."""
    n = len(data["sampleinfo"])
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    tab = np.full((n, 1), ord("\t"), dtype=np.uint8)
    parts = [_strings(data["sampleinfo"]), tab, bases[data["kmer"]], tab,
             _fixed6(data["means_micro"], ord(",")),
             _fixed6(data["stds_micro"], ord(",")),
             _ints2(data["lens"]),
             _fixed6(data["signals_micro"], ord(",")),
             _DIGITS[data["labels"]][:, None],
             np.full((n, 1), ord("\n"), dtype=np.uint8)]
    flat = np.concatenate(parts, axis=1).ravel()
    return flat[flat != 0].tobytes()
