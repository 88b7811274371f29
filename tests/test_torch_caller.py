"""The slice as a whole: call_mods on a feature TSV with a checkpoint written
by deepsignal_tpu, through the port (on the CPU) and through the JAX
package, compared row by row."""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from deepsignal_tpu.core.config import FeatureConfig as JaxFeatureConfig
from deepsignal_tpu.runtime.caller import run_call_mods as jax_run_call_mods
from deepsignal_tpu.train.checkpoints import save_checkpoint as jax_save
from deepsignal_tpu.core.config import ModelConfig as JaxModelConfig
from deepsignal_tpu_torch.cli.main import main as cli_main
from deepsignal_tpu_torch.core.config import ModelConfig
from deepsignal_tpu_torch.io.feature_codec import (format_feature_row,
                                                   parse_feature_lines)
from deepsignal_tpu_torch.models.deepsignal import DeepSignalNet
from deepsignal_tpu_torch.runtime import caller
from deepsignal_tpu_torch.train.checkpoints import state_dict_to_variables

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]

K, S = 5, 25
# 3 layers at hidden 128: the fused-encoder path
TINY = dict(lstm_hidden=128, lstm_layers=3, inception_times=1,
            inception_blocks=(1, 1, 1), kmer_len=K, cent_signals_len=S)
N_ROWS = 40
PROB_TOL = 1e-5  # float32 sums in another order


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("calls")
    cfg = ModelConfig(**TINY)
    torch.manual_seed(0)
    model = DeepSignalNet(cfg)
    rng = np.random.default_rng(11)
    with torch.no_grad():
        for name, t in model.state_dict().items():
            if name.endswith(("bias", "mean")):
                t.copy_(torch.from_numpy(rng.normal(0, 0.3, t.shape)))
            elif name.endswith(("scale", "var")):
                t.copy_(torch.from_numpy(rng.uniform(0.5, 2.0, t.shape)))
    ckpt = jax_save(str(d / "model.ckpt"), JaxModelConfig(**TINY),
                    state_dict_to_variables(cfg, model.state_dict()))
    rows = []
    for i in range(N_ROWS):
        rows.append(format_feature_row(
            "chr1", 100 + i, "+-"[i % 2], 100 + i, f"read{i // 6}", "t",
            "".join(rng.choice(list("ACGTN"), K)), rng.normal(0, 1, K),
            np.abs(rng.normal(0, 1, K)), rng.integers(1, 50, K),
            np.around(rng.normal(0, 1, S), 6), 1))
    tsv = d / "features.tsv"
    tsv.write_text("\n".join(rows) + "\n")
    return d, str(tsv), ckpt


def _read(path):
    with open(path) as f:
        return [line.rstrip("\n").split("\t") for line in f]


def test_call_mods_matches_jax(files, capsys):
    d, tsv, ckpt = files
    n = caller.run_call_mods(tsv, ckpt, str(d / "port.tsv"), batch_size=16,
                             f5_batch_num=3, compute_dtype="float32",
                             device="cpu")
    jax_run_call_mods(tsv, ckpt, str(d / "jax.tsv"),
                      JaxFeatureConfig(kmer_len=K, cent_signals_len=S),
                      batch_size=16, f5_batch_num=3, use_mesh=False,
                      compute_dtype="float32")
    got, want = _read(d / "port.tsv"), _read(d / "jax.tsv")
    assert n == N_ROWS and len(got) == len(want) == N_ROWS
    for g, w in zip(got, want):
        assert len(g) == 10
        assert g[:6] + g[8:] == w[:6] + w[8:]
        np.testing.assert_allclose(np.float32(g[6:8]), np.float32(w[6:8]),
                                   rtol=0, atol=PROB_TOL)
    identical = sum(g == w for g, w in zip(got, want))
    with capsys.disabled():
        print(f"\nport vs JAX call_mods, float32: {identical}/{N_ROWS} "
              f"lines byte-identical")


def test_cli_call_mods_matches_library(files):
    d, tsv, ckpt = files
    caller.run_call_mods(tsv, ckpt, str(d / "lib.tsv"), batch_size=8,
                         compute_dtype="float32", device="cpu")
    assert cli_main(["call_mods", "-i", tsv, "-m", ckpt, "-o",
                     str(d / "cli.tsv"), "-b", "8", "--compute_dtype",
                     "float32", "--device", "cpu", "-x", str(K), "-y",
                     str(S)]) == 0
    assert (d / "cli.tsv").read_bytes() == (d / "lib.tsv").read_bytes()


def test_padding_does_not_change_scores(files):
    d, tsv, ckpt = files
    out = {}
    for bs in (8, 64):
        caller.run_call_mods(tsv, ckpt, str(d / f"b{bs}.tsv"), batch_size=bs,
                             compute_dtype="float32", device="cpu")
        out[bs] = _read(d / f"b{bs}.tsv")
    for a, b in zip(out[8], out[64]):
        assert a[:6] + a[8:] == b[:6] + b[8:]
        np.testing.assert_allclose(np.float32(a[6:8]), np.float32(b[6:8]),
                                   rtol=0, atol=PROB_TOL)


def test_bf16_calls_track_float32(files):
    d, tsv, ckpt = files
    for dtype in ("float32", "bfloat16"):
        caller.run_call_mods(tsv, ckpt, str(d / f"{dtype}.tsv"),
                             batch_size=16, compute_dtype=dtype, device="cpu")
    f32, bf16 = _read(d / "float32.tsv"), _read(d / "bfloat16.tsv")
    p32 = np.float32([r[7] for r in f32])
    p16 = np.float32([r[7] for r in bf16])
    np.testing.assert_allclose(p16, p32, rtol=0, atol=2e-2)
    sure = np.abs(p32 - 0.5) > 2e-2
    assert [r[8] for r, s in zip(bf16, sure) if s] == \
        [r[8] for r, s in zip(f32, sure) if s]


def test_fast5_directory_input_is_not_yet_ported(files, tmp_path):
    """A fast5 directory calls where h5py cannot be imported (as on the
    card's machine): the port's ``run_call_mods`` runs in a process whose
    path puts an ``h5py`` that raises ImportError first, so its extract
    workers cannot import h5py either; its calls equal the JAX package's
    on the same files (half of them written by the port's writer, half by
    the JAX package's)."""
    from deepsignal_tpu.io.fast5 import write_synthetic_fast5 as jax_write
    from deepsignal_tpu_torch.io.fast5 import write_synthetic_fast5

    d, _, ckpt = files
    f5 = tmp_path / "fast5"
    f5.mkdir()
    rng = np.random.default_rng(12)
    for i in range(6):
        seq = "".join(rng.choice(list("ACGT"), 120))
        lengths = rng.integers(3, 15, 120)
        write = write_synthetic_fast5 if i % 2 else jax_write
        write(str(f5 / f"r{i}.fast5"), f"read-{i}",
              rng.integers(400, 900, int(lengths.sum()) + 5).astype(np.int16),
              np.concatenate([[0], np.cumsum(lengths)[:-1]]), lengths, seq,
              "chr1", 300 * i, "+-"[i % 2], read_start_rel_to_raw=2)
    blocker = tmp_path / "blocked"
    blocker.mkdir()
    (blocker / "h5py.py").write_text("raise ImportError('h5py is blocked')\n")
    script = tmp_path / "call.py"
    script.write_text(
        "import sys\n"
        "from deepsignal_tpu_torch.core.config import FeatureConfig\n"
        "from deepsignal_tpu_torch.runtime.caller import run_call_mods\n"
        "if __name__ == '__main__':\n"
        "    try:\n"
        "        import h5py  # noqa: F401\n"
        "        sys.exit('h5py imported')\n"
        "    except ImportError:\n"
        "        pass\n"
        f"    n = run_call_mods({str(f5)!r}, {ckpt!r}, "
        f"{str(tmp_path / 'port.tsv')!r}, FeatureConfig(kmer_len={K}, "
        f"cent_signals_len={S}), batch_size=16, f5_batch_num=2, "
        "compute_dtype='float32', device='cpu', nproc=3)\n"
        "    print(n)\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(blocker), str(REPO)] + os.environ.get("PYTHONPATH", "").split(
            os.pathsep)))
    out = subprocess.run([sys.executable, str(script)], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "0 of 6 fast5 files failed" in out.stdout
    jax_run_call_mods(str(f5), ckpt, str(tmp_path / "jax.tsv"),
                      JaxFeatureConfig(kmer_len=K, cent_signals_len=S),
                      batch_size=16, f5_batch_num=2, nproc=2, use_mesh=False,
                      compute_dtype="float32")
    got = sorted(_read(tmp_path / "port.tsv"))
    want = sorted(_read(tmp_path / "jax.tsv"))
    assert int(out.stdout.split()[-1]) == len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert a[:6] + a[8:] == b[:6] + b[8:]
        np.testing.assert_allclose(np.float32(a[6:8]), np.float32(b[6:8]),
                                   rtol=0, atol=PROB_TOL)


def test_wire_counts_round_trip_through_int16():
    counts = np.array([[0, 1, 40000, 65535, 70000]], dtype=np.int32)
    wire = caller.compact_wire_arrays(
        np.zeros((1, 5), np.int32), np.zeros((1, 5)), np.zeros((1, 5)),
        counts, np.zeros((1, 3)))
    assert [a.dtype for a in wire] == [np.int8, np.float32, np.float32,
                                       np.int16, np.float32]
    widened = torch.from_numpy(wire[3]).to(torch.int32) & 0xFFFF
    assert widened.tolist() == [[0, 1, 40000, 65535, 65535]]


def test_coalesce_feature_batches_keeps_order(files):
    _, tsv, _ = files
    with open(tsv) as f:
        lines = f.readlines()
    sizes = (3, 5, 2, 7, 1)
    cuts = np.cumsum((0,) + sizes)
    fbs = [parse_feature_lines(lines[a:b]) for a, b in zip(cuts, cuts[1:])]
    out = list(caller.coalesce_feature_batches(iter(fbs), 4))
    assert [len(b) for b in out] == [4, 4, 4, 4, 2]
    assert [s for b in out for s in b.sampleinfo] == \
        [s for b in fbs for s in b.sampleinfo]
    np.testing.assert_array_equal(np.concatenate([b.kmers for b in out]),
                                  np.concatenate([b.kmers for b in fbs]))
