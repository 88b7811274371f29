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
    assert "deepsignal_tpu_torch.ops.cuda.lstm" in modules
    code = ("import sys\n"
            f"for m in {modules!r}:\n"
            "    __import__(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'deepsignal_tpu'))\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_port_sources_name_neither_jax_nor_the_jax_package():
    # flax is named in docstrings as the author of the checkpoint format
    pattern = re.compile(r"\bjax\b|\bdeepsignal_tpu\.")
    files = [p for p in PORT.rglob("*") if p.suffix in (".py", ".cu", ".cuh")]
    files.append(REPO / "chip_smoke.py")
    offenders = [f"{p.relative_to(REPO)}:{i}"
                 for p in files
                 for i, line in enumerate(p.read_text().splitlines(), 1)
                 if pattern.search(line)]
    assert offenders == []


def test_cli_module_does_not_import_torch():
    code = ("import sys\n"
            "import deepsignal_tpu_torch.cli.main\n"
            "print('torch' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"


def test_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_call_mods(str(tmp_path / "f.tsv"), str(tmp_path / "model"),
                      str(tmp_path / "out.tsv"))
    assert not (tmp_path / "out.tsv").exists()
    assert resolve_device("cpu") == torch.device("cpu")
