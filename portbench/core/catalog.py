"""Find a cell's files by name.

A cell ``<config>.<traffic>`` is the file ``workloads/<cell>.json``; it
names its configuration (``configs/<config>.json``, with the driver
``drivers/<config>.py``, the plain reference ``reference/<config>.py`` and
the work count ``work/<config>.py``) and its traffic mix
(``traffic/<traffic>.json``). A metric ``<base>.<suffix>`` is read by
``metrics/<base>.py``. Which metrics a cell reports comes from
``BENCHMARK.json``. Each file is looked up in the roots in order, so a test
can put a fixture directory before the package and add a cell without
editing a file.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

__all__ = ["PACKAGE", "REPO", "Catalog"]

PACKAGE = Path(__file__).resolve().parents[1]
REPO = PACKAGE.parent


class Catalog:
    """The cells, configurations, traffic mixes, modules and metric lists
    found under ``roots`` and in the benchmark file."""

    def __init__(self, roots=(PACKAGE,), benchmark=REPO / "BENCHMARK.json"):
        self.roots = [Path(r) for r in roots]
        self.benchmark = json.loads(Path(benchmark).read_text())

    def find(self, rel: str) -> Path:
        for root in self.roots:
            path = root / rel
            if path.is_file():
                return path
        raise FileNotFoundError(f"no {rel} under {[str(r) for r in self.roots]}")

    def data(self, kind: str, name: str) -> dict:
        return json.loads(self.find(f"{kind}/{name}.json").read_text())

    def module(self, kind: str, name: str):
        """``<kind>/<name>.py`` imported by its path."""
        path = self.find(f"{kind}/{name}.py")
        if path.parent.parent == PACKAGE:
            modname = f"portbench.{kind}.{name}"
        else:
            modname = f"portbench_fixture.{path.parent.parent.name}.{kind}.{name}"
        if modname in sys.modules:
            return sys.modules[modname]
        spec = importlib.util.spec_from_file_location(modname, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[modname] = mod
        spec.loader.exec_module(mod)
        return mod

    def cell(self, name: str) -> dict:
        cell = self.data("workloads", name)
        listed = [w for w in self.benchmark["workloads"] if w["name"] == name]
        if len(listed) != 1:
            raise KeyError(f"cell {name} is not listed once in the benchmark file")
        for key in ("config", "traffic", "chips"):
            if cell[key] != listed[0][key]:
                raise ValueError(f"cell {name}: {key} is {cell[key]!r} in its "
                                 f"file and {listed[0][key]!r} in the "
                                 f"benchmark file")
        return cell

    def metrics(self, name: str, kind: str) -> list[dict]:
        """The ``end_to_end`` or ``per_layer`` entries that cell ``name``
        reports: those whose ``workloads`` list it; one without the key
        is reported where the end-to-end metric it moves is."""
        e2e = [m for m in self.benchmark["end_to_end"]
               if "workloads" not in m or name in m["workloads"]]
        if kind == "end_to_end":
            return e2e
        moved = {m["name"] for m in e2e}
        return [m for m in self.benchmark["per_layer"]
                if (name in m["workloads"] if "workloads" in m
                    else m["moves"] in moved)]

    def reader(self, metric: str):
        """The ``read(run)`` function of metric ``<base>.<suffix>``."""
        return self.module("metrics", metric.split(".")[0]).read
