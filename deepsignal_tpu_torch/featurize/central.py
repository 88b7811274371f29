"""Central raw-signal window selection (port of
deepsignal_tpu/featurize/central.py).

The reference rule (extract_features.py:154-190), on a flat signal array
and per-base offsets instead of a list of per-base slices:

- total signal < target  -> right-pad zeros
- middle base alone >= target -> *random sorted subsample of the middle-base
  signals* (nondeterministic in the reference; we use a seeded RNG by default,
  see FeatureConfig.central_sample_seed)
- otherwise: take floor((target - mid_len)/2) points left of the middle base
  and the rest to the right, clamping at the window borders.
"""

from __future__ import annotations

import random
from typing import Optional

import numpy as np


def get_central_signals(signals_list: list, rawsignal_num: int = 360,
                        rng: Optional[random.Random] = None) -> np.ndarray:
    """Reference-shaped API: list of per-base signal arrays -> [rawsignal_num]
    float64 window (extract_features.py:154-190)."""
    total = sum(len(x) for x in signals_list)

    if total < rawsignal_num:
        have = np.concatenate(signals_list)
        return np.append(have, np.zeros(rawsignal_num - len(have)))

    mid = (len(signals_list) - 1) // 2
    mid_seg = signals_list[mid]

    if len(mid_seg) >= rawsignal_num:
        # oversized middle base: random sorted subsample of its signals
        sampler = rng if rng is not None else random
        picks = sorted(sampler.sample(range(len(mid_seg)), rawsignal_num))
        return np.asarray([mid_seg[x] for x in picks])

    # split the remaining budget around the middle base, clamped to what is
    # actually available on each side of the window
    want_l = (rawsignal_num - len(mid_seg)) // 2
    want_r = rawsignal_num - want_l
    before = np.concatenate(signals_list[:mid]) if mid else np.empty(0)
    after = np.concatenate(signals_list[mid:])

    if want_l > len(before):
        want_r += want_l - len(before)
        want_l = len(before)
    elif want_r > len(after):
        want_l += want_r - len(after)
        want_r = len(after)

    assert want_r + want_l == rawsignal_num
    if want_l == 0:
        return after[:want_r]
    return np.append(before[-want_l:], after[:want_r])


def central_signals_batch(norm_signals: np.ndarray, starts: np.ndarray,
                          lengths: np.ndarray, win: np.ndarray,
                          rawsignal_num: int = 360,
                          rng: Optional[random.Random] = None) -> np.ndarray:
    """Vectorized central-signal rule for ALL sites of a read at once.

    ``win`` is the [S, K] event-index window matrix the extractor already
    builds; every output row follows the exact reference rule
    (extract_features.py:154-190).  The two common cases (short window ->
    zero-pad; split around the middle base) reduce to one contiguous slice
    per site — computed as a single [S, L] fancy-index gather — because tombo
    event segments are contiguous in the raw signal.  The rare oversized-
    middle-base case (mid_len >= L, needs a random subsample) falls back to
    the scalar rule per affected site, consuming ``rng`` in site order so
    byte-parity with the per-site loop is preserved
    (the reference's site order).
    """
    S, K = win.shape
    L = rawsignal_num
    mid = (K - 1) // 2
    arange_l = np.arange(L, dtype=np.int64)

    win_start = starts[win[:, 0]]
    win_end = starts[win[:, -1]] + lengths[win[:, -1]]
    total = win_end - win_start
    mid_start = starts[win[:, mid]]
    mid_len = lengths[win[:, mid]]

    # split case: budget around the middle base, clamped to each side
    left_len = (L - mid_len) // 2
    right_len = L - left_len
    n_left = mid_start - win_start
    n_right = win_end - mid_start
    over_l = left_len > n_left
    right_len = np.where(over_l, right_len + left_len - n_left, right_len)
    left_len = np.where(over_l, n_left, left_len)
    over_r = (right_len > n_right) & ~over_l
    left_len = np.where(over_r, left_len + right_len - n_right, left_len)
    right_len = np.where(over_r, n_right, right_len)
    slice_start = mid_start - left_len
    valid = np.full(S, L, dtype=np.int64)

    # short-window case: start at the window, zero-pad the tail
    short = total < L
    slice_start = np.where(short, win_start, slice_start)
    valid = np.where(short, total, valid)

    n = norm_signals.shape[0]
    mask = arange_l[None, :] >= valid[:, None]
    if n >= L:
        # Each output row is one CONTIGUOUS span, so gather whole rows from
        # a sliding-window view (one memcpy per row) instead of a [S, L]
        # elementwise fancy index — measured 4x on the gather.  Rows whose
        # span would run past the signal end (short windows at the read
        # tail) copy just their valid prefix; the tail is masked to zero
        # below either way.
        from numpy.lib.stride_tricks import sliding_window_view
        out = np.empty((S, L), dtype=np.float64)
        safe = slice_start <= n - L
        out[safe] = sliding_window_view(norm_signals, L)[slice_start[safe]]
        for i in np.nonzero(~safe)[0]:
            v = min(int(valid[i]), n - int(slice_start[i]))
            out[i, :v] = norm_signals[slice_start[i]:slice_start[i] + v]
            out[i, v:] = 0.0
    else:  # whole read shorter than the window: every row is the pad case
        idx = slice_start[:, None] + arange_l[None, :]
        np.clip(idx, 0, n - 1, out=idx)
        out = norm_signals[idx].astype(np.float64, copy=False)
    if mask.any():
        out[mask] = 0.0

    oversized = mid_len >= L  # disjoint from ``short`` (mid is in the window)
    if oversized.any():
        for i in np.nonzero(oversized)[0]:
            w = win[i]
            out[i] = central_signals_flat(norm_signals, starts[w],
                                          lengths[w], L, rng)
    return out


def central_signals_flat(norm_signals: np.ndarray, seg_starts: np.ndarray,
                         seg_lens: np.ndarray, rawsignal_num: int = 360,
                         rng: Optional[random.Random] = None) -> np.ndarray:
    """Same rule on a flat window: ``seg_starts``/``seg_lens`` describe the
    k per-base segments of one site window within ``norm_signals`` (segments
    are contiguous in tombo events, so the window is a single flat span).

    Faster path used by the vectorized extractor; falls back to the exact
    list-based rule only in the rare oversized-middle-base case.
    """
    k = len(seg_starts)
    mid = (k - 1) // 2
    win_start = int(seg_starts[0])
    win_end = int(seg_starts[-1] + seg_lens[-1])
    total = win_end - win_start

    if total < rawsignal_num:
        out = np.zeros(rawsignal_num, dtype=np.float64)
        out[:total] = norm_signals[win_start:win_end]
        return out

    mid_start = int(seg_starts[mid])
    mid_len = int(seg_lens[mid])
    if mid_len >= rawsignal_num:
        sampler = rng if rng is not None else random
        picks = sorted(sampler.sample(range(mid_len), rawsignal_num))
        return norm_signals[mid_start + np.asarray(picks, dtype=np.int64)]

    left_len = (rawsignal_num - mid_len) // 2
    right_len = rawsignal_num - left_len
    n_left = mid_start - win_start            # signals left of the middle base
    n_right = win_end - mid_start             # middle base + right signals

    if left_len > n_left:
        right_len = right_len + left_len - n_left
        left_len = n_left
    elif right_len > n_right:
        left_len = left_len + right_len - n_right
        right_len = n_right

    return norm_signals[mid_start - left_len: mid_start + right_len].astype(
        np.float64, copy=False)
