"""The port stands alone: it imports neither JAX nor deepsignal_tpu, and its
entry points refuse to fall back to the CPU when CUDA is missing."""

import pathlib
import re
import subprocess
import sys

import pytest
import torch

from deepsignal_tpu_torch.core.device import resolve_device
from deepsignal_tpu_torch.runtime.caller import run_call_mods

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "deepsignal_tpu_torch"


def _port_modules():
    return sorted(".".join(p.relative_to(REPO).with_suffix("").parts)
                  .removesuffix(".__init__")
                  for p in PORT.rglob("*.py") if p.name != "__main__.py")


def test_port_modules_import_without_jax():
    modules = _port_modules()
    for name in ("ops.cuda.lstm", "io.native", "runtime.pipeline",
                 "tools.dataset", "train.denoise", "io.fast5", "io.fasta",
                 "featurize.extractor", "featurize.signal",
                 "featurize.central", "tools.frequency", "tools.combine",
                 "tools.evaluate", "tools.runner", "tools.vis",
                 "models.tf1_import", "core.logging", "parallel.dist",
                 "parallel.mesh"):
        assert f"deepsignal_tpu_torch.{name}" in modules
    # matplotlib is imported at the first plot only
    code = ("import sys\n"
            f"for m in {modules!r}:\n"
            "    __import__(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'deepsignal_tpu', 'matplotlib'))\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_port_sources_name_neither_jax_nor_the_jax_package():
    # flax is named in docstrings as the author of the checkpoint format
    pattern = re.compile(r"\bjax\b|\bdeepsignal_tpu\.")
    files = [p for p in PORT.rglob("*")
             if p.suffix in (".py", ".cu", ".cuh", ".cpp", ".h")]
    assert {p.name for p in files} >= {"fastparse.cpp", "callfmt.cpp",
                                       "featkernel.cpp"}
    files.append(REPO / "chip_smoke.py")
    offenders = [f"{p.relative_to(REPO)}:{i}"
                 for p in files
                 for i, line in enumerate(p.read_text().splitlines(), 1)
                 if pattern.search(line)]
    assert offenders == []


def test_port_modules_import_without_h5py():
    """With h5py blocked, every port module imports, and a fast5 file is
    written and read back as the read it was written from."""
    code = ("import sys\n"
            "sys.modules['h5py'] = None\n"
            f"for m in {_port_modules()!r}:\n"
            "    __import__(m)\n"
            "import dataclasses, os, tempfile\n"
            "import numpy as np\n"
            "from deepsignal_tpu_torch.io import fast5\n"
            "kw = dict(read_id='r', raw_signal=np.arange(40, dtype=np.int16),\n"
            "          event_starts_rel=np.arange(0, 40, 4),\n"
            "          event_lengths=np.full(10, 4), seq='ACGTACGTAC',\n"
            "          mapped_chrom='c', mapped_start=7, mapped_strand='-',\n"
            "          read_start_rel_to_raw=2)\n"
            "with tempfile.TemporaryDirectory() as d:\n"
            "    path = os.path.join(d, 'x.fast5')\n"
            "    fast5.write_synthetic_fast5(path, **kw)\n"
            "    got = fast5.read_resquiggled_fast5(path)\n"
            "want = fast5.synthetic_read(**kw)\n"
            "for f in dataclasses.fields(want):\n"
            "    a, b = getattr(got, f.name), getattr(want, f.name)\n"
            "    assert type(a) is type(b) and np.array_equal(a, b), f.name\n"
            "    assert getattr(a, 'dtype', 0) == getattr(b, 'dtype', 0)\n"
            "print('h5py' in sys.modules and sys.modules['h5py'] is not None)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"


def test_port_sources_import_no_h5py():
    """No module of the port, and not chip_smoke.py, imports h5py: the
    card's machine has none, and the port reads fast5 files itself."""
    pattern = re.compile(r"^\s*(import\s+h5py|from\s+h5py\b)|"
                         r"import_module\(\s*[\"']h5py|"
                         r"__import__\(\s*[\"']h5py", re.M)
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert REPO / "deepsignal_tpu_torch" / "io" / "hdf5.py" in files
    offenders = [str(p.relative_to(REPO)) for p in files
                 if pattern.search(p.read_text())]
    assert offenders == []
    # and the check sees an import where there is one
    assert pattern.search("x = 1\n    import h5py\n")
    assert pattern.search("from h5py import File\n")


def test_cli_module_does_not_import_torch():
    code = ("import sys\n"
            "import deepsignal_tpu_torch.cli.main\n"
            "print('torch' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"


def test_host_only_subcommands_load_no_process_group_code(tmp_path):
    """A host-only subcommand (call_freq) runs with torch importable and
    leaves torch, and so torch.distributed, unloaded: only the model
    subcommands make a process group."""
    calls = tmp_path / "calls.tsv"
    calls.write_text("chr1\t5\t+\t5\tr1\tt\t0.2\t0.8\t1\tAACGT\n"
                     "chr1\t5\t+\t5\tr2\tt\t0.9\t0.1\t0\tAACGT\n")
    code = ("import sys\n"
            "from deepsignal_tpu_torch.cli.main import main\n"
            f"assert main(['call_freq', '-i', {str(calls)!r}, '-o', "
            f"{str(tmp_path / 'freq.tsv')!r}]) == 0\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] == "
            "'torch'))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
    assert (tmp_path / "freq.tsv").stat().st_size > 0


def test_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_call_mods(str(tmp_path / "f.tsv"), str(tmp_path / "model"),
                      str(tmp_path / "out.tsv"))
    assert not (tmp_path / "out.tsv").exists()
    assert resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_fails_without_a_card_or_a_checkout(tmp_path, where):
    """chip_smoke.py exits non-zero and prints no result line on a machine
    without CUDA, and in a directory that holds it and nothing else of the
    repo (where it must fail on the card too: a run there with rc 1 is the
    check working, not a fault)."""
    script = REPO / "chip_smoke.py"
    if where == "alone":
        (tmp_path / "chip_smoke.py").write_bytes(script.read_bytes())
        script = tmp_path / "chip_smoke.py"
    out = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "chip_smoke: FAIL" in out.stderr
