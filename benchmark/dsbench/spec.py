"""Everything a run finds by name: the cell in ``BENCHMARK.json``, its
configuration file and reference, its traffic file and driver, its limits
file, the readers of its metrics and the counting functions.

A cell ``<c>`` of configuration ``<cfg>`` under traffic ``<t>`` is made of
``configs/<cfg>.json`` (which names ``references/<ref>.py``),
``traffic/<t>.json`` (which names ``drivers/<driver>.py``) and
``limits/<c>.json``; a metric ``<m>`` is read by ``metrics/<m>.py``; a
counting function ``<k>`` is ``counts/<k>.py``.  Adding any of them is
adding files.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKOUT = os.path.dirname(HERE)


def benchmark(root: str = CHECKOUT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def read_json(kind: str, name: str, base: str = HERE) -> dict:
    with open(os.path.join(base, kind, f"{name}.json")) as f:
        return json.load(f)


def load(kind: str, name: str, base: str = HERE):
    """The module ``<base>/<kind>/<name>.py``, loaded once per process."""
    key = f"dsbench_{kind}_{name}".replace(".", "_").replace("-", "_")
    if key not in sys.modules:
        path = os.path.join(base, kind, f"{name}.py")
        if not os.path.exists(path):
            raise FileNotFoundError(f"no {kind}/{name}.py")
        spec = importlib.util.spec_from_file_location(key, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        spec.loader.exec_module(mod)
    return sys.modules[key]


class Cell:
    """One entry of ``workloads`` and the files it is made of."""

    def __init__(self, name: str, bench: dict, base: str = HERE):
        found = [w for w in bench["workloads"] if w["name"] == name]
        if not found:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.entry = found[0]
        self.name = name
        self.chips = self.entry["chips"]
        self.config = read_json("configs", self.entry["config"], base)
        self.traffic = read_json("traffic", self.entry["traffic"], base)
        self.limits = read_json("limits", name, base)
        self.reference = load("references", self.config["reference"], base)
        self.driver = load("drivers", self.traffic["driver"], base)
        self.base = base
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in bench["per_layer"]
                          if name in m.get("workloads", [name])]

    @property
    def sizes(self) -> dict:
        """The model's sizes (the configuration without its bookkeeping)."""
        return self.config["model"]

    @property
    def dtype(self) -> str:
        """The compute dtype this cell's entry point runs in."""
        return self.config["compute_dtype"][self.traffic["entry"]]

    def reader(self, metric: str):
        return load("metrics", metric, self.base)

    def count(self, part: str, batch: int) -> tuple:
        """(operations, bytes) of ``counts/<part>.py`` at ``batch`` in this
        cell's dtype."""
        elem = {"bfloat16": 2, "float32": 4}[self.dtype]
        return load("counts", part, self.base).count(self.sizes, batch, elem)
