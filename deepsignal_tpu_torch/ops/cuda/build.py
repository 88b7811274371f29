"""Build the native sources in ``deepsignal_tpu_torch/csrc`` at first use.

Each source has a plain C interface and is compiled into its own shared
library, which is loaded with ``ctypes``: ``csrc/<name>.cu`` by ``nvcc`` for
Hopper (``sm_90a``), ``csrc/<name>.cpp`` (host code) by ``$CXX`` or ``g++``.
Libraries go into ``build/deepsignal_tpu_torch/`` beside the package, named
by a hash of the source and the flags, so an edited source is rebuilt and an
unchanged one is reused; the compiler's report (for ``nvcc`` ptxas's
registers and spills) is kept beside it.  A failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "deepsignal_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# no -ffast-math, -march=native or contraction into FMA: the featurizer's
# sums must round as numpy's do (csrc/featkernel.cpp)
CXX_FLAGS = ("-O3", "-std=c++17", "-ffp-contract=off", "-shared", "-fPIC")

_loaded: dict = {}


def nvcc_path() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels are "
                       "built on the machine with the card")


def cxx_path() -> str:
    cxx = os.environ.get("CXX") or "g++"
    found = shutil.which(cxx)
    if found is None:
        raise RuntimeError(f"host C++ compiler {cxx!r} not found (set CXX)")
    return found


def source_path(name: str) -> Path:
    """``csrc/<name>.cu`` or ``csrc/<name>.cpp``, whichever exists."""
    for suffix in (".cu", ".cpp"):
        path = CSRC / f"{name}{suffix}"
        if path.exists():
            return path
    raise FileNotFoundError(f"no csrc/{name}.cu or csrc/{name}.cpp")


def _flags(src: Path) -> tuple:
    return NVCC_FLAGS if src.suffix == ".cu" else CXX_FLAGS


def library_path(name: str) -> Path:
    src = source_path(name)
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(_flags(src)).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build_libraries(names) -> dict:
    """Compile every source in ``names`` that has no current build, one
    compiler each, all started together.  Returns {name: compiler report},
    for a library that was already built the report of its build."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    reports = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            log = out.with_suffix(".log")
            reports[name] = log.read_text() if log.exists() else ""
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        src = source_path(name)
        compiler = nvcc_path() if src.suffix == ".cu" else cxx_path()
        cmd = [compiler, *_flags(src), "-o", str(tmp), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        reports[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}: {Path(proc.args[0]).name} exited "
                          f"{proc.returncode}\n{log}")
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or none
    if failed:
        raise RuntimeError("native build failed:\n" + "\n".join(failed))
    return reports


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>``, built first if needed."""
    if name not in _loaded:
        build_libraries([name])
        _loaded[name] = ctypes.CDLL(str(library_path(name)))
    return _loaded[name]
