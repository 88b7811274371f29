"""The port's extract workers, ``run_extract`` and ``call_mods`` on a fast5
directory, against the JAX package's, and their behaviour when a worker
dies.  Every wait is bounded."""

import multiprocessing as mp
import os
import signal as signals
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from deepsignal_tpu.core.config import FeatureConfig as JaxFeatureConfig
import deepsignal_tpu.runtime.pipeline as jax_pipeline
from deepsignal_tpu.runtime.caller import run_call_mods as jax_run_call_mods
from deepsignal_tpu_torch.cli.main import main as cli_main
from deepsignal_tpu_torch.core.config import FeatureConfig
from deepsignal_tpu_torch.io.fast5 import synthetic_read, write_synthetic_fast5
from deepsignal_tpu_torch.runtime import pipeline
from deepsignal_tpu_torch.runtime.caller import run_call_mods

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_tiny as tt  # noqa: E402

torch.set_num_threads(1)

K, SIG = 5, 24
CFG = dict(kmer_len=K, cent_signals_len=SIG)
N_READS = 8
PROB_TOL = 1e-5  # float32 sums in another order (test_torch_caller.py)
BOUND_S = 120    # no run of these small sets takes near this


def _read_kwargs(n_reads=N_READS, n_bases=160, seed=77):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_reads):
        seq = "".join(np.array(list("ACGT"))[rng.integers(0, 4, n_bases)])
        lengths = rng.integers(3, 20, size=n_bases)
        starts = np.concatenate([[0], np.cumsum(lengths)[:-1]])
        raw = rng.integers(400, 900,
                           size=int(lengths.sum()) + 5).astype(np.int16)
        out.append(dict(read_id=f"rid-{i}", raw_signal=raw,
                        event_starts_rel=starts, event_lengths=lengths,
                        seq=seq, mapped_chrom="chrI",
                        mapped_start=1000 * i,
                        mapped_strand="+" if i % 2 == 0 else "-",
                        read_start_rel_to_raw=3))
    return out


@pytest.fixture(scope="module")
def fast5_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("f5")
    (d / "sub").mkdir()
    for i, kw in enumerate(_read_kwargs()):
        where = d / "sub" if i % 3 == 0 else d
        write_synthetic_fast5(str(where / f"r{i}.fast5"), **kw)
    return str(d)


def _run_bounded(fn, timeout=BOUND_S):
    """Run ``fn`` in a thread; return its result, failing if it does not
    end within ``timeout`` seconds."""
    out = {}

    def target():
        try:
            out["value"] = fn()
        except BaseException as exc:  # handed to the test
            out["error"] = exc

    t = threading.Thread(target=target, daemon=True)
    t.start()
    t.join(timeout)
    assert not t.is_alive(), f"still waiting after {timeout} s"
    if "error" in out:
        raise out["error"]
    return out["value"]


def _sorted_rows(path):
    with open(path) as f:
        return sorted(f.read().splitlines())


def _dir_rows(path):
    return sorted(r for name in os.listdir(path)
                  for r in open(os.path.join(path, name)).read().splitlines())


def _extra_processes():
    return [p for p in mp.active_children()
            if p.name.startswith((pipeline.WORKER_NAME, pipeline.WRITER_NAME))]


@pytest.mark.parametrize("nproc", [1, 4])
def test_run_extract_matches_jax(fast5_dir, tmp_path, nproc):
    stats = {}
    errors = _run_bounded(lambda: pipeline.run_extract(
        fast5_dir, str(tmp_path / "port.tsv"), FeatureConfig(**CFG),
        nproc=nproc, f5_batch_num=2, stats=stats))
    jax_pipeline.run_extract(fast5_dir, str(tmp_path / "jax.tsv"),
                             JaxFeatureConfig(**CFG), nproc=2,
                             f5_batch_num=3)
    got = _sorted_rows(tmp_path / "port.tsv")
    assert errors == 0 and got and got == _sorted_rows(tmp_path / "jax.tsv")
    assert stats["n_workers"] == max(1, nproc - 1)
    assert stats["n_batches"] == N_READS // 2 and stats["rows"] == len(got)
    assert stats["lost_batches"] == stats["crashed_workers"] == 0
    assert _extra_processes() == []


def test_run_extract_to_a_directory_matches_jax(fast5_dir, tmp_path):
    _run_bounded(lambda: pipeline.run_extract(
        fast5_dir, str(tmp_path / "port"), FeatureConfig(**CFG), nproc=3,
        f5_batch_num=1, w_is_dir=True, w_batch_num=3))
    jax_pipeline.run_extract(fast5_dir, str(tmp_path / "jax"),
                             JaxFeatureConfig(**CFG), nproc=3, f5_batch_num=1,
                             w_is_dir=True, w_batch_num=3)
    assert sorted(os.listdir(tmp_path / "port")) == ["0.tsv", "1.tsv",
                                                    "2.tsv"]
    assert _dir_rows(tmp_path / "port") == _dir_rows(tmp_path / "jax")


def test_run_extract_of_in_memory_reads_matches_the_directory(fast5_dir,
                                                              tmp_path):
    reads = [synthetic_read(**kw) for kw in _read_kwargs()]
    _run_bounded(lambda: pipeline.run_extract_reads(
        reads, str(tmp_path / "mem.tsv"), FeatureConfig(**CFG), nproc=3,
        f5_batch_num=3))
    _run_bounded(lambda: pipeline.run_extract(
        fast5_dir, str(tmp_path / "dir.tsv"), FeatureConfig(**CFG), nproc=3,
        f5_batch_num=3))
    assert _sorted_rows(tmp_path / "mem.tsv") == \
        _sorted_rows(tmp_path / "dir.tsv")


def test_a_writer_that_cannot_write_raises(fast5_dir, tmp_path):
    target = tmp_path / "a_file"
    target.write_text("")
    with pytest.raises(RuntimeError, match="feature writer"):
        _run_bounded(lambda: pipeline.run_extract(
            fast5_dir, str(target), FeatureConfig(**CFG), nproc=2,
            f5_batch_num=1, w_is_dir=True))
    assert _extra_processes() == []


# A script whose top level, run again as ``__mp_main__`` in each spawned
# worker, puts the native segment means one ulp off numpy's; its main runs
# one entry point on two reads.
_ULP_OFF_SCRIPT = """
import sys

import numpy as np

from deepsignal_tpu_torch.io import native

_real = native.segment_stats


def _one_ulp_off(*args):
    means, stds = _real(*args)
    return np.nextafter(means, np.inf), stds


_one_ulp_off.calls = 0
native.segment_stats = _one_ulp_off

if __name__ == "__main__":
    from deepsignal_tpu_torch.core.config import FeatureConfig
    from deepsignal_tpu_torch.io.fast5 import synthetic_read
    from deepsignal_tpu_torch.runtime import pipeline

    entry, fast5_dir, out = sys.argv[1:]
    cfg = FeatureConfig(kmer_len=5, cent_signals_len=24)
    if entry == "run_extract":
        pipeline.run_extract(fast5_dir, out, cfg, nproc=2, f5_batch_num=1)
    else:
        rng = np.random.default_rng(3)
        reads = []
        for i in range(2):
            lengths = rng.integers(3, 20, 120)
            reads.append(synthetic_read(
                f"r{i}", rng.integers(400, 900, int(lengths.sum()) + 5
                                      ).astype(np.int16),
                np.concatenate([[0], np.cumsum(lengths)[:-1]]), lengths,
                "".join(rng.choice(list("ACGT"), 120)), "chrI", 0, "+"))
        list(pipeline.stream_read_feature_batches(reads, cfg, nproc=2,
                                                  f5_batch_num=1))
    print("finished")
"""


@pytest.mark.parametrize("entry", ["run_extract",
                                   "stream_read_feature_batches"])
def test_a_worker_whose_featurizer_differs_fails_the_run(fast5_dir, tmp_path,
                                                         entry):
    """The workers' check of the native featurizer raises in the parent;
    it is not counted as the reads' errors."""
    import subprocess
    script = tmp_path / "ulp_off.py"
    script.write_text(_ULP_OFF_SCRIPT)
    out = subprocess.run(
        [sys.executable, str(script), entry, fast5_dir,
         str(tmp_path / "out.tsv")], capture_output=True, text=True,
        timeout=BOUND_S, env={**os.environ, "PYTHONPATH": os.pathsep.join(
            [os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
             os.environ.get("PYTHONPATH", "")])})
    assert out.returncode != 0 and "finished" not in out.stdout
    assert "RuntimeError: the native segment mean differs" in out.stderr, \
        out.stderr[-2000:]


def test_extract_fast5_batch_raises_when_the_featurizer_differs(monkeypatch):
    from deepsignal_tpu_torch.core.constants import get_motif_seqs
    from deepsignal_tpu_torch.featurize import extractor, signal
    from deepsignal_tpu_torch.io import native
    real = native.segment_stats

    def off_by_one_ulp(*args):
        means, stds = real(*args)
        return np.nextafter(means, np.inf), stds
    off_by_one_ulp.calls = 0
    monkeypatch.setattr(native, "segment_stats", off_by_one_ulp)
    signal.featurizer_checked.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="segment mean differs"):
            extractor.extract_fast5_batch(
                [synthetic_read(**kw) for kw in _read_kwargs(n_reads=2)],
                get_motif_seqs("CG"), FeatureConfig(**CFG))
    finally:
        monkeypatch.undo()
        signal.featurizer_checked.cache_clear()


def test_cli_extract_fails_when_every_file_fails(tmp_path, capsys):
    bad = tmp_path / "bad"
    bad.mkdir()
    for i in range(3):
        (bad / f"x{i}.fast5").write_bytes(b"not an hdf5 file")
    assert cli_main(["extract", "-i", str(bad), "-o",
                     str(tmp_path / "out.tsv"), "-p", "2"]) == 1
    assert "all 3 fast5 files failed" in capsys.readouterr().err
    assert _extra_processes() == []


def _by_info(batches):
    """All rows of a stream's batches, sorted by sampleinfo."""
    import deepsignal_tpu_torch.io.feature_codec as fc
    cat = fc.FeatureBatch.concat(list(batches))
    order = np.argsort(np.array(cat.sampleinfo), kind="stable")
    return cat, order


def test_stream_matches_jax_bit_for_bit(fast5_dir):
    from deepsignal_tpu_torch.io import native
    stats = {}
    calls = native.segment_stats.calls
    got, go = _by_info(_run_bounded(lambda: list(
        pipeline.stream_fast5_feature_batches(
            fast5_dir, FeatureConfig(**CFG), nproc=3, f5_batch_num=2,
            stats=stats))))
    want, wo = _by_info(jax_pipeline.stream_fast5_feature_batches(
        fast5_dir, JaxFeatureConfig(**CFG), nproc=2, f5_batch_num=2))
    assert [got.sampleinfo[i] for i in go] == \
        [want.sampleinfo[i] for i in wo]
    for name in ("kmers", "means", "stds", "lens", "signals", "labels"):
        a, b = getattr(got, name)[go], getattr(want, name)[wo]
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name
    assert stats == {"errors": 0, "lost_batches": 0, "crashed_workers": 0,
                     "n_batches": N_READS // 2, "n_workers": 2,
                     "first_batch_s": stats["first_batch_s"]}
    assert stats["first_batch_s"] > 0
    # the workers' native calls, one per read, counted in the parent
    assert native.segment_stats.calls - calls == N_READS


def test_rows_do_not_depend_on_the_worker_count(tmp_path):
    # oversized middle bases: the subsample draws from each read's own
    # generator, in site order
    kws = _read_kwargs(n_reads=6, seed=5)
    for kw in kws:
        kw["event_lengths"] = kw["event_lengths"] * 3
        kw["event_starts_rel"] = np.concatenate(
            [[0], np.cumsum(kw["event_lengths"])[:-1]])
        kw["raw_signal"] = np.resize(kw["raw_signal"],
                                     int(kw["event_lengths"].sum()) + 5)
    reads = [synthetic_read(**kw) for kw in kws]
    out = {}
    for nproc in (2, 4):
        path = tmp_path / f"n{nproc}.tsv"
        _run_bounded(lambda: pipeline.run_extract_reads(
            reads, str(path), FeatureConfig(**CFG), nproc=nproc,
            f5_batch_num=1))
        out[nproc] = _sorted_rows(path)
    assert out[2] and out[2] == out[4]


@pytest.fixture(scope="module")
def long_fast5_dir(tmp_path_factory):
    """``fast5_dir``'s reads at 8,000 bases: a batch takes a worker ~10 ms,
    so a kill that follows the first answer lands while the workers still
    hold batches (at 160 bases they can drain all eight first)."""
    d = tmp_path_factory.mktemp("f5long")
    for i, kw in enumerate(_read_kwargs(n_bases=8000)):
        write_synthetic_fast5(str(d / f"r{i}.fast5"), **kw)
    return str(d)


def test_a_sigkilled_worker_is_accounted_for(long_fast5_dir, capsys):
    """Five runs, each bounded: one of two workers is killed after the first
    batch; the run ends, the dead worker is counted with the batch it held,
    and every other batch arrives."""
    fast5_dir = long_fast5_dir
    for attempt in range(5):
        stats = {}

        def run():
            stream = pipeline.stream_fast5_feature_batches(
                fast5_dir, FeatureConfig(**CFG), nproc=3, f5_batch_num=1,
                stats=stats)
            got = [next(stream)]
            os.kill(stats["workers"][attempt % 2].pid, signals.SIGKILL)
            got += list(stream)
            return got
        batches = _run_bounded(run, timeout=60)
        assert stats["crashed_workers"] == 1
        assert stats["lost_batches"] <= 1
        assert len(batches) + stats["lost_batches"] == stats["n_batches"] \
            == N_READS
        assert "worker(s) died mid-run" in capsys.readouterr().out
    assert _extra_processes() == []


def test_when_every_worker_dies_the_rest_is_lost(long_fast5_dir):
    fast5_dir = long_fast5_dir
    stats = {}

    def run():
        stream = pipeline.stream_fast5_feature_batches(
            fast5_dir, FeatureConfig(**CFG), nproc=2, f5_batch_num=1,
            stats=stats)
        got = [next(stream)]
        os.kill(stats["workers"][0].pid, signals.SIGKILL)
        return got + list(stream)
    batches = _run_bounded(run, timeout=60)
    assert stats["crashed_workers"] == 1
    assert len(batches) + stats["lost_batches"] == N_READS
    assert stats["lost_batches"] >= N_READS - 2


def test_closing_an_unread_stream_stops_its_workers(fast5_dir):
    stream = pipeline.stream_fast5_feature_batches(
        fast5_dir, FeatureConfig(**CFG), nproc=3, f5_batch_num=1)
    assert len(_extra_processes()) == 2
    t0 = time.time()
    stream.close()
    assert time.time() - t0 < pipeline.JOIN_S
    assert _extra_processes() == []


def test_the_worker_modules_import_no_torch():
    import subprocess
    code = ("import sys\n"
            "import deepsignal_tpu_torch.runtime.pipeline\n"
            "import deepsignal_tpu_torch.featurize.extractor\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'jax', 'deepsignal_tpu')))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=60,
                         cwd=os.path.dirname(os.path.dirname(
                             os.path.abspath(__file__))))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


# --------------------------------------------------------------------------
# call_mods on a fast5 directory


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    from deepsignal_tpu_torch.train.checkpoints import (
        save_checkpoint, state_dict_to_variables)
    cfg = tt.tiny_cfg()
    return save_checkpoint(
        str(tmp_path_factory.mktemp("model") / "m.ckpt"), cfg,
        state_dict_to_variables(cfg, tt.tiny_state_dict()))


@pytest.fixture(scope="module")
def site_files(tmp_path_factory, fast5_dir):
    d = tmp_path_factory.mktemp("sites")
    ref = d / "ref.fa"
    ref.write_text(">chrI\n" + "A" * 9000 + "\n>chrJ\nACGT\n")
    rows = _sorted_rows_of_dir(fast5_dir)
    pos = d / "positions.tsv"
    pos.write_text("".join("\t".join(r.split("\t")[:3]) + "\n"
                           for r in rows[::2]))
    return str(ref), str(pos)


def _sorted_rows_of_dir(fast5_dir):
    from deepsignal_tpu_torch.core.constants import get_motif_seqs
    from deepsignal_tpu_torch.featurize.extractor import extract_fast5_batch
    from deepsignal_tpu_torch.io.fast5 import get_fast5s
    feats, _ = extract_fast5_batch(sorted(get_fast5s(fast5_dir)),
                                   get_motif_seqs("CG"),
                                   FeatureConfig(kmer_len=tt.K,
                                                 cent_signals_len=tt.S))
    return sorted(r for f in feats for r in f.to_tsv_rows())


def _calls(path):
    with open(path) as f:
        return sorted(line.rstrip("\n").split("\t") for line in f)


def test_call_mods_on_a_directory_matches_jax(fast5_dir, ckpt, site_files,
                                              tmp_path):
    ref, pos = site_files
    kw = dict(reference_path=ref, position_file=pos, f5_batch_num=2)
    n = _run_bounded(lambda: run_call_mods(
        fast5_dir, ckpt, str(tmp_path / "port.tsv"),
        FeatureConfig(kmer_len=tt.K, cent_signals_len=tt.S), batch_size=16,
        compute_dtype="float32", device="cpu", nproc=3, **kw))
    jax_run_call_mods(fast5_dir, ckpt, str(tmp_path / "jax.tsv"),
                      JaxFeatureConfig(kmer_len=tt.K, cent_signals_len=tt.S),
                      batch_size=16, nproc=2, use_mesh=False,
                      compute_dtype="float32", **kw)
    got, want = _calls(tmp_path / "port.tsv"), _calls(tmp_path / "jax.tsv")
    assert n == len(got) == len(want) > 0
    assert len(want) == (len(_sorted_rows_of_dir(fast5_dir)) + 1) // 2
    assert all(r[3] != "-1" for r in got)  # the reference gave the length
    for g, w in zip(got, want):
        assert g[:6] + g[8:] == w[:6] + w[8:]
        np.testing.assert_allclose(np.float32(g[6:8]), np.float32(w[6:8]),
                                   rtol=0, atol=PROB_TOL)


def test_cli_extract_and_call_mods_match_the_library(fast5_dir, ckpt,
                                                     tmp_path):
    flags = ["-x", str(tt.K), "-y", str(tt.S)]
    pipeline.run_extract(fast5_dir, str(tmp_path / "lib.tsv"),
                         FeatureConfig(kmer_len=tt.K, cent_signals_len=tt.S),
                         nproc=2, f5_batch_num=3)
    assert cli_main(["extract", "-i", fast5_dir, "-o",
                     str(tmp_path / "cli.tsv"), "-p", "2",
                     "--f5_batch_num", "3", *flags]) == 0
    assert _sorted_rows(tmp_path / "cli.tsv") == \
        _sorted_rows(tmp_path / "lib.tsv")

    run_call_mods(fast5_dir, ckpt, str(tmp_path / "lib_calls.tsv"),
                  FeatureConfig(kmer_len=tt.K, cent_signals_len=tt.S),
                  batch_size=16, compute_dtype="float32", device="cpu")
    assert cli_main(["call_mods", "-i", fast5_dir, "-m", ckpt, "-o",
                     str(tmp_path / "cli_calls.tsv"), "-b", "16", "-p", "3",
                     "--compute_dtype", "float32", "--device", "cpu",
                     *flags]) == 0
    assert _calls(tmp_path / "cli_calls.tsv") == \
        _calls(tmp_path / "lib_calls.tsv")


def test_call_mods_of_a_directory_and_of_its_extracted_tsv_agree(
        fast5_dir, ckpt, tmp_path):
    """The stream casts the unrounded float64 means to float32; the TSV
    rounds them to 6 decimals first: labels equal, probabilities close."""
    cfg = FeatureConfig(kmer_len=tt.K, cent_signals_len=tt.S)
    pipeline.run_extract(fast5_dir, str(tmp_path / "f.tsv"), cfg)
    for src, out in ((fast5_dir, "dir.tsv"), (str(tmp_path / "f.tsv"),
                                              "tsv.tsv")):
        run_call_mods(src, ckpt, str(tmp_path / out), cfg, batch_size=16,
                      compute_dtype="float32", device="cpu")
    a, b = _calls(tmp_path / "dir.tsv"), _calls(tmp_path / "tsv.tsv")
    assert len(a) == len(b) > 0
    assert [r[:6] + r[8:] for r in a] == [r[:6] + r[8:] for r in b]
    np.testing.assert_allclose(np.float32([r[6:8] for r in a]),
                               np.float32([r[6:8] for r in b]), rtol=0,
                               atol=1e-4)


GOLDEN_SCRIPT = '''
import dataclasses
import os
import sys

import numpy as np

from deepsignal_tpu_torch.cli import main as cli
from deepsignal_tpu_torch.io.fast5 import write_synthetic_fast5

if __name__ == "__main__":
    try:
        import h5py  # noqa: F401
        sys.exit("h5py imported")
    except ImportError:
        pass
    where, out = sys.argv[1:]
    # the golden fixture's reads, drawn as tests/test_golden.py draws them
    rng = np.random.default_rng(424242)
    genome = "".join(np.array(list("ACGT"))[rng.integers(0, 4, 3000)])
    for i, strand in enumerate(["+", "-", "+"]):
        start = 700 * i
        seq = genome[start:start + 250]
        lengths = rng.integers(3, 22, size=len(seq))
        starts = np.concatenate([[0], np.cumsum(lengths)[:-1]])
        raw = rng.integers(380, 920,
                           size=int(lengths.sum()) + 7).astype(np.int16)
        write_synthetic_fast5(os.path.join(where, "fast5", f"g{i}.fast5"),
                              read_id=f"golden-{i}", raw_signal=raw,
                              event_starts_rel=starts, event_lengths=lengths,
                              seq=seq, mapped_chrom="chrG",
                              mapped_start=start, mapped_strand=strand,
                              read_start_rel_to_raw=4)
    ref = os.path.join(where, "ref.fa")
    with open(ref, "w") as f:
        f.write(">chrG\\n" + genome + "\\n")
    # the golden rows were drawn with central_sample_seed 99, which the
    # CLI (as the JAX package's) has no flag for
    feature_cfg = cli._feature_cfg_from_args
    cli._feature_cfg_from_args = lambda args: dataclasses.replace(
        feature_cfg(args), central_sample_seed=99)
    sys.exit(cli.main(["extract", "-i", os.path.join(where, "fast5"), "-o",
                       out, "--reference_path", ref, "-p", "2"]))
'''


def test_golden_features_from_files_written_and_read_without_h5py(tmp_path):
    """The golden fixture's three reads, written by the port's writer and
    extracted through the port's CLI in processes that cannot import h5py
    (an ``h5py`` that raises ImportError is first on their path, the
    spawned workers' too), give tests/golden/features_golden.tsv byte for
    byte (its rows sorted: the files are listed in directory order)."""
    blocker = tmp_path / "blocked"
    blocker.mkdir()
    (blocker / "h5py.py").write_text("raise ImportError('h5py is blocked')\n")
    (tmp_path / "fast5").mkdir()
    script = tmp_path / "golden.py"
    script.write_text(GOLDEN_SCRIPT)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(blocker), repo] + os.environ.get("PYTHONPATH", "").split(
            os.pathsep)))
    out = tmp_path / "features.tsv"
    done = subprocess.run([sys.executable, str(script), str(tmp_path),
                           str(out)], env=env, cwd=repo, capture_output=True,
                          text=True, timeout=BOUND_S)
    assert done.returncode == 0, done.stderr
    assert "0 of 3 fast5 files failed" in done.stdout
    with open(os.path.join(repo, "tests", "golden",
                           "features_golden.tsv"), "rb") as f:
        want = f.read()
    got = out.read_bytes()
    assert got.endswith(b"\n") and want.endswith(b"\n")
    assert sorted(got.splitlines()) == sorted(want.splitlines())
    assert len(got) == len(want)
