"""The port's API keeps step with the JAX package's.

Both packages are walked with ``ast``, without importing them.  For every
module of ``deepsignal_tpu`` the port's module of the same path must have
each public top-level function and class, each public method, each
constructor keyword (a dataclass's or flax module's fields where the class
defines no ``__init__``) and each keyword of a function or method that both
have; an ``__init__.py`` must also export the same names, eagerly or through
a module ``__getattr__``.  A name is present in the port where it is
defined or imported at the module's top level.  The only exceptions are in
``ALLOWED``, each with its reason, and an entry that no longer names a
difference fails too, so the list cannot go stale.
"""

import ast
import pathlib

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
JAX = REPO / "deepsignal_tpu"
PORT = REPO / "deepsignal_tpu_torch"

# "<module>::<name>" for a name the port lacks, "<module>::<name>(<keyword>)"
# for a keyword; the reason is one line.
ALLOWED = {
    "ops/pallas/__init__.py::bilstm_encoder_fused":
        "TPU only: the Pallas entry points; the port's K1 is ops/cuda/lstm.py",
    "ops/pallas/__init__.py::bilstm_encoder_pallas":
        "TPU only: the Pallas entry points; the port's K1 is ops/cuda/lstm.py",
    "ops/pallas/__init__.py::lstm_layer_pallas":
        "TPU only: the Pallas entry points; the port's K2 is "
        "ops/cuda/lstm_scan.py",
    "ops/pallas/lstm.py::bilstm_encoder_fused":
        "TPU only: the Pallas K1; the port's is ops/cuda/lstm.py",
    "ops/pallas/lstm.py::bilstm_encoder_pallas":
        "TPU only: the Pallas K1; the port's is ops/cuda/lstm.py",
    "ops/pallas/lstm.py::lstm_layer_pallas":
        "TPU only: the Pallas K2; the port's is ops/cuda/lstm_scan.py",
    "ops/bilstm.py::bilstm_encoder_xla":
        "TPU only: the XLA scan of lstm_impl='xla'; the port's plain version "
        "is bilstm_encoder_fused_plain",
    "parallel/mesh.py::batch_sharding":
        "JAX only: a NamedSharding; the port's ranks hold their block "
        "(local_block)",
    "parallel/mesh.py::replicated":
        "JAX only: a NamedSharding; every rank holds the whole model",
    "parallel/mesh.py::put_batch":
        "JAX only: device_put onto a sharding; a rank copies its own block",
    "parallel/mesh.py::put_replicated":
        "JAX only: device_put onto a sharding; a rank copies its own model",
    "parallel/mesh.py::host_local_rows":
        "JAX only: rows of a global jax.Array; a rank's tensors are local",
    "parallel/mesh.py::make_mesh(local)":
        "JAX only: a host-local mesh; the port runs one process per GPU",
    "parallel/mesh.py::param_shardings(params)":
        "the port names an nn.Module's parameters (model), not a flax tree",
    "parallel/dist.py::init_distributed(coordinator_address)":
        "JAX only: jax.distributed's arguments; torchrun's environment "
        "gives them",
    "parallel/dist.py::init_distributed(num_processes)":
        "JAX only: jax.distributed's arguments; torchrun's environment "
        "gives them",
    "parallel/dist.py::init_distributed(process_id)":
        "JAX only: jax.distributed's arguments; torchrun's environment "
        "gives them",
    "core/config.py::ModelConfig(matmul_precision)":
        "XLA only: the dot precision of XLA's TPU matmuls",
    "core/config.py::ModelConfig(lstm_impl)":
        "TPU only: picks the XLA scan or the Pallas kernel",
    "models/layers.py::BiLSTMEncoder(impl)":
        "TPU only: the lstm_impl family; the port picks K1 or K2 by shape",
    "models/layers.py::TFLSTMLayer(reverse)":
        "flax module field: the port's encoder runs each direction itself",
    "models/layers.py::ConvBNRelu(features)":
        "flax module field: a torch module takes in_ch and out_ch",
    "models/layers.py::TFLSTMLayer.setup":
        "flax only: parameters are made in nn.Module.__init__",
    "models/layers.py::TFLSTMLayer.params_in":
        "flax only: a bound module's cast parameters; the port reads "
        ".kernel and .bias",
    "models/deepsignal.py::init_model":
        "flax's (model, variables); the port's form is init_weights and "
        "model_from_state_dict",
    "runtime/caller.py::compact_wire_arrays(wire_f)":
        "the port's wire is float32, cast on the device to the compute "
        "dtype",
    "runtime/caller.py::ModCaller(mesh)":
        "JAX only: a caller over a host-local mesh; the port has one "
        "process per GPU",
    "runtime/caller.py::run_call_mods(use_mesh)":
        "JAX only: the host-local mesh; the port has one process per GPU",
    "runtime/caller.py::run_call_mods(lstm_impl)":
        "TPU only: the lstm_impl family",
    "tools/dataset.py::concat_two_files(seed)":
        "the port takes an explicit numpy Generator (rng), drawn in JAX's "
        "order",
    "tools/dataset.py::shuffle_big_file(seed)":
        "the port takes an explicit numpy Generator (rng), drawn in JAX's "
        "order",
    "train/checkpoints.py::save_train_state(opt_state)":
        "optax's state; the port saves torch.optim.Adam's",
    "train/checkpoints.py::save_train_state(rng)":
        "a JAX PRNG key; the port saves its torch.Generator's state",
    "train/checkpoints.py::load_train_state(opt_state_template)":
        "an optax template; torch's optimizer state needs none",
    "train/checkpoints.py::load_train_state(rng_template)":
        "a JAX PRNG key template; torch's generator state needs none",
    "train/trainer.py::Trainer(rng)":
        "a JAX PRNG key; the port's Trainer seeds its weights and its "
        "dropout torch.Generator from TrainConfig.seed",
    "train/trainer.py::Trainer.restore(opt_state)":
        "optax's state; the port restores Adam's from train_state",
    "train/trainer.py::Trainer.restore(rng)":
        "a JAX PRNG key; the port restores its torch.Generator from "
        "train_state",
}


def _params(fn) -> list:
    a = fn.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    names += [x.arg for x in (a.vararg, a.kwarg) if x is not None]
    return [n for n in names if n not in ("self", "cls")]


def _lazy_exports(fn) -> list:
    """The names a module ``__getattr__`` answers: ``name == "<x>"`` or
    ``name in ("<x>", ...)``."""
    out = []
    for node in ast.walk(fn):
        if isinstance(node, ast.Compare) and len(node.comparators) == 1:
            right = node.comparators[0]
            items = right.elts if isinstance(right, ast.Tuple) else [right]
            out += [c.value for c in items if isinstance(c, ast.Constant)
                    and isinstance(c.value, str)]
    return out


def api(path: pathlib.Path, with_imports: bool) -> dict:
    """{name: keywords or None} of a module's public API: top-level
    functions, classes (their constructor keywords), methods; imported
    names where ``with_imports`` (or the module is an ``__init__.py``), and
    a module ``__getattr__``'s names."""
    if not path.exists():
        return {}
    out = {}
    imports = with_imports or path.name == "__init__.py"
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.FunctionDef):
            if node.name == "__getattr__":
                out.update((n, None) for n in _lazy_exports(node))
            elif not node.name.startswith("_"):
                out[node.name] = _params(node)
        elif isinstance(node, (ast.Import, ast.ImportFrom)) and imports:
            for alias in node.names:
                name = (alias.asname or alias.name).split(".")[0]
                if not name.startswith("_"):
                    out.setdefault(name, None)
        elif isinstance(node, ast.ClassDef) and not node.name.startswith("_"):
            init = None
            fields = [s.target.id for s in node.body
                      if isinstance(s, ast.AnnAssign)
                      and isinstance(s.target, ast.Name)]
            for sub in node.body:
                if not isinstance(sub, ast.FunctionDef):
                    continue
                if sub.name == "__init__":
                    init = _params(sub)
                elif not sub.name.startswith("_"):
                    out[f"{node.name}.{sub.name}"] = _params(sub)
            out[node.name] = init if init is not None else fields
    return out


def differences(rel: str) -> list:
    """The JAX names and keywords of module ``rel`` that the port lacks."""
    want = api(JAX / rel, with_imports=False)
    have = api(PORT / rel, with_imports=True)
    out = []
    for name, keywords in want.items():
        if name not in have:
            out.append(f"{rel}::{name}")
        elif keywords and have[name] is not None:
            out += [f"{rel}::{name}({k})" for k in keywords
                    if k not in have[name]]
    return out


JAX_MODULES = sorted(p.relative_to(JAX).as_posix() for p in JAX.rglob("*.py"))


@pytest.mark.parametrize("rel", JAX_MODULES)
def test_port_has_every_public_name_and_keyword(rel):
    missing = [d for d in differences(rel) if d not in ALLOWED]
    assert missing == []


@pytest.mark.parametrize("entry", sorted(ALLOWED))
def test_every_allowed_difference_is_still_one(entry):
    rel = entry.split("::")[0]
    assert entry in differences(rel)
    assert ALLOWED[entry].strip()


def test_the_walk_sees_a_removed_name_and_keyword(tmp_path):
    """The walk is not blind: a port module without a JAX function, or
    with a keyword renamed, differs."""
    src = "def f(a, b=1):\n    pass\n\n\nclass C:\n    x: int\n"
    (tmp_path / "jax.py").write_text(src)
    (tmp_path / "port.py").write_text(src.replace("b=1", "c=1")
                                      .replace("x: int", "y: int"))
    want = api(tmp_path / "jax.py", with_imports=False)
    have = api(tmp_path / "port.py", with_imports=True)
    assert want == {"f": ["a", "b"], "C": ["x"]}
    assert have == {"f": ["a", "c"], "C": ["y"]}
    (tmp_path / "port.py").write_text("from os import path as f\n")
    assert api(tmp_path / "port.py", with_imports=True) == {"f": None}
    (tmp_path / "__init__.py").write_text(
        "def __getattr__(name):\n    if name in ('a', 'b') or name == 'c':"
        "\n        return 1\n")
    assert api(tmp_path / "__init__.py", with_imports=False) == {
        "a": None, "b": None, "c": None}
