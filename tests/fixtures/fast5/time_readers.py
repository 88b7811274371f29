"""Time one fast5 read through the port's reader (``io/hdf5.py``) and
through the JAX package's (h5py's low-level API), on the CPU this runs on.
Run from the root of the repository:

    python tests/fixtures/fast5/time_readers.py [--bases 8000] [--reps 300]

It writes one seeded read of ``--bases`` bases (the draw of chip_smoke.py's
reads) twice, with the port's writer and with the JAX package's (h5py),
and prints each reader's median µs per read on each file, and a plain
``open().read()`` of the file for scale.
"""

import argparse
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))))))

from deepsignal_tpu.io import fast5 as jax_fast5  # noqa: E402
from deepsignal_tpu_torch.io import fast5  # noqa: E402


def median_us(fn, reps: int) -> float:
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return float(np.median(times) * 1e6)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--bases", type=int, default=8000)
    ap.add_argument("--reps", type=int, default=300)
    args = ap.parse_args()
    rng = np.random.default_rng(606)
    seq = "".join(np.array(list("ACGT"))[rng.integers(0, 4, args.bases)])
    lengths = rng.integers(3, 22, size=args.bases)
    starts = np.concatenate([[0], np.cumsum(lengths)[:-1]])
    raw = rng.integers(380, 920, size=int(lengths.sum()) + 7).astype(np.int16)
    kw = dict(read_id="read-0000", raw_signal=raw, event_starts_rel=starts,
              event_lengths=lengths, seq=seq, mapped_chrom="chr1",
              mapped_start=0, mapped_strand="+", read_start_rel_to_raw=4)
    with tempfile.TemporaryDirectory() as d:
        for writer, name in ((fast5.write_synthetic_fast5, "port-written"),
                             (jax_fast5.write_synthetic_fast5, "h5py-written")):
            path = os.path.join(d, f"{name}.fast5")
            writer(path, **kw)

            def plain(path=path):
                with open(path, "rb") as f:
                    f.read()

            print(f"{name} file, {os.path.getsize(path)} bytes: "
                  f"port reader {median_us(lambda: fast5.read_resquiggled_fast5(path), args.reps):.1f} µs, "  # noqa: E501
                  f"h5py reader {median_us(lambda: jax_fast5.read_resquiggled_fast5(path), args.reps):.1f} µs, "  # noqa: E501
                  f"open().read() {median_us(plain, args.reps):.1f} µs "
                  f"(median of {args.reps})")


if __name__ == "__main__":
    main()
