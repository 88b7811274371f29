"""Raw-signal math (port of deepsignal_tpu/featurize/signal.py): pA
rescaling, read-level normalization, per-event segment statistics.

Semantics of the reference:

- pA = ``scaling * (raw + offset)`` with ``scaling = range / digitisation``
  (extract_features.py:193-212).
- MAD normalization divides by the Gaussian-consistent MAD of
  ``statsmodels.robust.mad``: ``median(|x - median(x)| / 0.6744897501960817)``
  (extract_features.py:147), and rounds to 6 decimals (:151).
- Per-event means and stds are np.mean / np.std (ddof 0) of each slice
  (extract_features.py:273-274), in numpy's pairwise summation order.

``segment_stats`` runs the native kernel (``csrc/featkernel.cpp``);
``segment_stats_plain``, the grouped numpy reduction, is its plain version.
Where the JAX package probes its native kernels at import and quietly falls
back to numpy on a mismatch, the port probes them at first use
(``featurizer_checked``) and raises with the values that differ.
"""

from __future__ import annotations

import functools

import numpy as np

from ..io import native

# scipy.stats.norm.ppf(0.75): the statsmodels `robust.mad` denominator.
MAD_SCALE = 0.6744897501960817
# the segment lengths of the check: every regime of numpy's pairwise
# summation (n < 8 unrolled, 8 <= n <= 128 blocked, n > 128 recursive)
PROBE_LENGTHS = (1, 2, 7, 8, 9, 16, 100, 129, 1000, 4096)


def rescale_signals(raw_signals: np.ndarray, scaling: float,
                    offset: float) -> np.ndarray:
    """DAC values -> picoamps (extract_features.py:211-212); float64."""
    return np.asarray(scaling * (raw_signals + offset), dtype=np.float64)


def normalize_signals(signals: np.ndarray,
                      normalize_method: str = "mad") -> np.ndarray:
    """Whole-read normalization (extract_features.py:143-151), float64
    rounded to 6 decimals as ``np.around(..., decimals=6)``.

    The MAD path takes its medians from numpy's single-kth partition
    (``_fast_median``), as the JAX package does."""
    signals = np.asarray(signals, dtype=np.float64)
    if normalize_method == "zscore":
        sshift, sscale = np.mean(signals), float(np.std(signals))
    elif normalize_method == "mad":
        if signals.size == 0:
            return signals
        sshift = _fast_median(signals)
        # statsmodels.robust.mad divides elementwise by c before the median
        sscale = float(_fast_median(np.abs(signals - sshift) / MAD_SCALE))
    else:
        raise ValueError("normalize_method must be 'mad' or 'zscore'")
    return np.around((signals - sshift) / sscale, decimals=6)


def _fast_median(x: np.ndarray) -> float:
    """np.median's bits from one single-kth partition: the k-th order
    statistic does not depend on the selection algorithm, and an even
    length takes the same (lo + hi) / 2.  NaN inputs go to np.median, so
    that NaN propagates."""
    if np.isnan(np.max(x, initial=-np.inf)):
        return float(np.median(x))
    n = x.shape[0]
    k = (n - 1) // 2
    part = np.partition(x, k)
    if n % 2:
        return float(part[k])
    return float((part[k] + part[k + 1:].min()) / 2.0)


def _check_segments(n: int, starts: np.ndarray, lengths: np.ndarray) -> None:
    if lengths.min(initial=1) <= 0:
        raise ValueError("all event lengths must be positive")
    if (starts + lengths).max(initial=0) > n:
        raise ValueError("event extends past end of signal")


def segment_stats(norm_signals: np.ndarray, starts: np.ndarray,
                  lengths: np.ndarray):
    """Per-event (means, stds) float64 [num_events] over
    ``norm_signals[starts[i] : starts[i] + lengths[i]]``, by the native
    kernel in numpy's summation order (the reference's per-slice np.mean /
    np.std, extract_features.py:273-274)."""
    starts = np.asarray(starts, dtype=np.int64)
    lengths = np.asarray(lengths, dtype=np.int64)
    _check_segments(norm_signals.shape[0], starts, lengths)
    featurizer_checked()
    return native.segment_stats(norm_signals, starts, lengths)


def segment_stats_plain(norm_signals: np.ndarray, starts: np.ndarray,
                        lengths: np.ndarray):
    """The plain version of ``segment_stats``: segments grouped by length,
    each group gathered into a C-contiguous [m, L] matrix and reduced along
    its rows, where numpy applies the same pairwise routine to each row as
    to a 1-D slice."""
    starts = np.asarray(starts, dtype=np.int64)
    lengths = np.asarray(lengths, dtype=np.int64)
    _check_segments(norm_signals.shape[0], starts, lengths)
    norm_signals = np.ascontiguousarray(norm_signals, dtype=np.float64)
    means = np.empty(starts.shape[0], dtype=np.float64)
    stds = np.empty(starts.shape[0], dtype=np.float64)
    for seg_len in np.unique(lengths):
        idx = np.nonzero(lengths == seg_len)[0]
        rows = norm_signals[starts[idx][:, None] + np.arange(seg_len)]
        means[idx] = rows.mean(axis=1)
        stds[idx] = rows.std(axis=1)
    return means, stds


def format_rows6_plain(x: np.ndarray) -> list:
    """The plain version of ``native.format_rows6``: each row of a [S, K]
    float64 matrix as its values' ``str()`` joined by commas."""
    return [",".join(str(v) for v in row) for row in np.asarray(x)]


def _differences(got, want, probe=None) -> list:
    """The first few (value, native, numpy) triples that differ."""
    got, want = np.asarray(got), np.asarray(want)
    bad = np.flatnonzero(~((got == want) | (np.isnan(got) & np.isnan(want)))
                         if got.dtype.kind == "f" else got != want)
    return [(None if probe is None else float(probe[i]), got[i], want[i])
            for i in bad[:8]]


@functools.cache
def featurizer_checked() -> None:
    """Hold the native featurizer kernels against numpy once per process,
    on the JAX package's import-time probe (signal.py:29-66): segment
    means and stds bit for bit at every pairwise-summation regime, and the
    6-decimal text byte for byte across the fast path, its 1e-4 and 1e9
    edges, the other regimes, signed zeros and the specials, and the
    float64 next to the installed numpy's positional range.  Raises
    RuntimeError with the values that differ; nothing falls back.  The
    check's own calls are not counted."""
    counted = (native.segment_stats, native.format_rows6)
    calls = [fn.calls for fn in counted]
    try:
        rng = np.random.RandomState(12345)
        lengths = np.array(PROBE_LENGTHS, dtype=np.int64)
        starts = np.concatenate([[0], np.cumsum(lengths)[:-1]])
        sig = np.round(rng.standard_normal(int(lengths.sum())), 6)
        means, stds = native.segment_stats(sig, starts, lengths)
        want_m = np.array([np.mean(sig[s:s + n])
                           for s, n in zip(starts, lengths)])
        want_s = np.array([np.std(sig[s:s + n])
                           for s, n in zip(starts, lengths)])
        for name, got, want in (("mean", means, want_m),
                                ("std", stds, want_s)):
            if not np.array_equal(got.view(np.int64), want.view(np.int64)):
                raise RuntimeError(
                    f"the native segment {name} differs from numpy's (another "
                    f"summation order?) at lengths "
                    f"{lengths[got != want].tolist()}: "
                    f"{_differences(got, want)}")

        lo, hi = native.positional_range(np.float64)
        edges = [np.nextafter(v, to) for v in (lo, hi, 1e-4, 1e9)
                 for to in (0.0, np.inf)]
        probe = np.around(np.concatenate([
            rng.standard_normal(256),
            rng.standard_normal(64) * 1e-4,
            rng.uniform(1e8, 2e9, 64) * np.where(rng.rand(64) < 0.5, -1, 1),
            np.array([0.0, -0.0, 1e-7, -1e-7, 2.0, 0.25, 1e-4, 1e9, 1e15,
                      1e16, 1e17, 123456789.123456, np.inf, -np.inf,
                      np.nan, lo, -lo, hi, -hi])]), 6)
        probe = np.concatenate([probe, edges])
        got = native.format_rows6(probe.reshape(-1, 1))
        want = format_rows6_plain(probe.reshape(-1, 1))
        if got != want:
            raise RuntimeError(
                f"the native 6-decimal text differs from numpy's str() "
                f"(positional for {lo:g} <= |x| < {hi:g}): "
                f"{_differences(got, want, probe)}")
    finally:
        for fn, n in zip(counted, calls):
            fn.calls = n
