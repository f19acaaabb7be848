"""What the benchmark is made of, found by name.

`BENCHMARK.json` at the checkout's root names the cells, the configurations
and the metrics. Everything that belongs to one of them lives in a file of
its own under this folder, found by the name alone:

  configs/<config>.json     a configuration (its `driver` names the entry driver)
  workloads/<traffic>.json  a traffic mix: the parameters the driver reads
  drivers/<driver>.py       the code that drives the program for a configuration
  metrics/<metric>.py       the reader of one metric, end-to-end or per-layer
  kernels/<family>.json     kernel-name fragments -> a kernel family

so a later change adds a cell, a metric or a kernel family by adding files.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType

HERE = Path(__file__).resolve().parent


class Bench:
    """The benchmark rooted at `root` (the checkout: it holds BENCHMARK.json),
    with its files under `root / folder`."""

    def __init__(self, root: Path | str = HERE.parent, folder: str = HERE.name):
        self.root = Path(root)
        self.dir = self.root / folder
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())
        self._modules: dict[Path, ModuleType] = {}

    def path(self, relative: str) -> Path:
        """A file named relative to the checkout's root."""
        return self.root / relative

    def cell(self, name: str) -> dict:
        for cell in self.spec["workloads"]:
            if cell["name"] == name:
                return cell
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        entry = next((c for c in self.spec["configs"] if c["name"] == name), None)
        if entry is None:
            raise KeyError(f"no config {name!r} in BENCHMARK.json")
        return json.loads(self.path(entry["file"]).read_text())

    def traffic(self, name: str) -> dict:
        return json.loads((self.dir / "workloads" / f"{name}.json").read_text())

    def _module(self, kind: str, name: str) -> ModuleType:
        path = self.dir / kind / f"{name}.py"
        if path not in self._modules:
            if not path.is_file():
                raise FileNotFoundError(f"no {kind} file {path}")
            mod_name = f"_bench_{kind}_{name}".replace(".", "_").replace("-", "_")
            spec = importlib.util.spec_from_file_location(mod_name, path)
            module = importlib.util.module_from_spec(spec)
            sys.modules[mod_name] = module  # dataclasses look their module up there
            spec.loader.exec_module(module)
            self._modules[path] = module
        return self._modules[path]

    def driver(self, name: str) -> ModuleType:
        return self._module("drivers", name)

    def reader(self, metric: str) -> ModuleType:
        return self._module("metrics", metric)

    def kernel_tables(self) -> list[tuple[str, tuple[str, ...]]]:
        """(family, lower-case name fragments) in the order they are tried:
        each table's `order`, then its name. The first table with a fragment
        in a kernel's name takes the kernel."""
        tables = []
        for path in sorted((self.dir / "kernels").glob("*.json")):
            data = json.loads(path.read_text())
            tables.append((data["order"], path.stem, tuple(f.lower() for f in data["fragments"])))
        return [(name, frags) for _, name, frags in sorted(tables)]

    def end_to_end(self, cell: dict) -> list[dict]:
        """The end-to-end metrics this cell reports."""
        return [m for m in self.spec["end_to_end"] if "workloads" not in m or cell["name"] in m["workloads"]]

    def per_layer(self, cell: dict) -> list[dict]:
        """The per-layer metrics read in this cell's traced run: those that
        list it, and those without a list whose end-to-end metric it reports."""
        reported = {m["name"] for m in self.end_to_end(cell)}
        return [
            m
            for m in self.spec["per_layer"]
            if (cell["name"] in m["workloads"] if "workloads" in m else m["moves"] in reported)
        ]


def family_of(name: str, tables: list[tuple[str, tuple[str, ...]]]) -> str | None:
    """The family whose table first names a fragment of `name`; None when no
    table does."""
    low = name.lower()
    for fam, frags in tables:
        if any(f in low for f in frags):
            return fam
    return None
