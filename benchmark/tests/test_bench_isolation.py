"""Nothing a run of the benchmark imports is JAX or the JAX package, and
the plain reference imports nothing of the program: by a walk of the
sources' imports, and by the modules a process holds once it has loaded
every part of the harness."""

import ast
import pathlib
import subprocess
import sys

from tiny import BENCH, REPO

FORBIDDEN = {"jax", "jaxlib", "flax", "deepsignal_tpu"}
PORT = "deepsignal_tpu_torch"


def _imports(path: pathlib.Path) -> set:
    """Top-level names of every module ``path`` imports (absolute and
    relative to its package)."""
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


def _port_file(module: str):
    path = REPO / pathlib.Path(*module.split("."))
    for cand in (path.with_suffix(".py"), path / "__init__.py"):
        if cand.exists():
            return cand
    return None


def _walk(files) -> set:
    """Top-level names reached from ``files``, through the port's modules
    (absolute and relative imports followed)."""
    seen, todo, tops = set(), list(files), set()
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.add(path)
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            mods = []
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                if node.level:
                    pkg = path.parent
                    for _ in range(node.level - 1):
                        pkg = pkg.parent
                    base = ".".join(pkg.relative_to(REPO).parts)
                    mods = [f"{base}.{node.module}" if node.module else base]
                    mods += [f"{m}.{a.name}" for m in mods[:1]
                             for a in node.names]
                else:
                    mods = [node.module] + [f"{node.module}.{a.name}"
                                            for a in node.names]
            for m in mods:
                tops.add(m.split(".")[0])
                if m.split(".")[0] == PORT:
                    f = _port_file(m)
                    if f is not None:
                        todo.append(f)
    return tops


def _harness_files():
    return [p for p in BENCH.rglob("*.py") if "tests" not in p.parts]


def test_walk_finds_no_jax_and_the_reference_no_program():
    tops = _walk(_harness_files())
    assert PORT in tops  # the walk reached the program
    assert not tops & FORBIDDEN, sorted(tops & FORBIDDEN)
    for ref in (BENCH / "references").glob("*.py"):
        assert _imports(ref) <= {"__future__", "math", "numpy", "torch",
                                 "torch.nn.functional"}, ref


def test_a_process_with_every_part_loaded_holds_no_jax():
    code = f"""
import sys
sys.path[:0] = [{str(REPO)!r}, {str(BENCH)!r}]
import run, calibrate
from dsbench import spec, faults, pipe_writer, readings, tracing, traffic, weights
bench = spec.benchmark()
for w in bench["workloads"]:
    cell = spec.Cell(w["name"], bench)
    for m in cell.end_to_end + cell.per_layer:
        cell.reader(m["name"])
    for part in ("encoder", "inception", "head", "model"):
        cell.count(part, 1)
import deepsignal_tpu_torch.runtime.caller, deepsignal_tpu_torch.train.trainer
print(sorted({{m.split(".")[0] for m in sys.modules}} & set({sorted(FORBIDDEN)!r})))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_forbidden_names_are_compared_whole():
    sys.path.insert(0, str(BENCH))
    import run
    assert "deepsignal_tpu_torch" not in run.FORBIDDEN
    saved = dict(sys.modules)
    try:
        sys.modules["deepsignal_tpu_torch_x"] = object()
        assert run.forbidden_modules() == sorted(
            {m.split(".")[0] for m in saved} & set(run.FORBIDDEN))
        sys.modules["deepsignal_tpu.io"] = object()
        assert "deepsignal_tpu" in run.forbidden_modules()
    finally:
        sys.modules.pop("deepsignal_tpu_torch_x", None)
        sys.modules.pop("deepsignal_tpu.io", None)
