"""The benchmark's manifest and the files it names.

``BENCHMARK.json`` sits at the checkout's root.  Everything that belongs to
one configuration, traffic mix, entry point or metric is a file of its own
under the benchmark's folder (the first entry of ``paths``), found by the
name that the manifest gives it:

  * ``configs/<config>.json`` (the path is the config's ``file``)
  * ``traffic/<traffic>.json``
  * ``drivers/<entry>.py`` and ``reference/<entry>.py``, where ``entry``
    is the configuration's entry point
  * ``limits/<cell>.json``, the limits of the numbers that decide ``correct``
  * ``metrics/<metric>.py``, one reader for each metric, end-to-end or
    per-layer
  * ``peaks.json``, the data sheets' peaks by card name

So a later cell, mix, driver or metric is added as files alone.
"""

from __future__ import annotations

import importlib.util
import json
import pathlib
from types import ModuleType
from typing import Dict, List, Optional


class Manifest:
    """``BENCHMARK.json`` under ``root`` and lookups of its named files."""

    def __init__(self, root):
        self.root = pathlib.Path(root)
        self.data = json.loads((self.root / "BENCHMARK.json").read_text())
        self.bench = self.root / self.data["paths"][0]
        self._modules: Dict[pathlib.Path, ModuleType] = {}

    @staticmethod
    def _named(entries: List[dict], name: str, what: str) -> dict:
        for e in entries:
            if e["name"] == name:
                return e
        known = ", ".join(e["name"] for e in entries)
        raise KeyError(f"no {what} named {name!r} in BENCHMARK.json "
                       f"(known: {known})")

    def cell(self, name: str) -> dict:
        return self._named(self.data["workloads"], name, "workload")

    def config(self, name: str) -> dict:
        entry = self._named(self.data["configs"], name, "config")
        return json.loads((self.root / entry["file"]).read_text())

    def traffic(self, name: str) -> dict:
        return json.loads((self.bench / "traffic" / f"{name}.json")
                          .read_text())

    def limits(self, cell: str) -> dict:
        return json.loads((self.bench / "limits" / f"{cell}.json")
                          .read_text())

    def peaks(self, device_name: str) -> Optional[dict]:
        """The data sheet's peaks of the card whose name holds an entry's
        ``match``; None for a device the table does not list."""
        table = json.loads((self.bench / "peaks.json").read_text())
        for entry in table["cards"]:
            if entry["match"] in device_name:
                return entry
        return None

    def module(self, kind: str, name: str) -> ModuleType:
        """``<bench>/<kind>/<name>.py``, loaded by its path (a name may hold
        dots, which an import statement would read as packages)."""
        path = self.bench / kind / f"{name}.py"
        mod = self._modules.get(path)
        if mod is None:
            if not path.is_file():
                raise FileNotFoundError(f"no {kind} file {path}")
            spec = importlib.util.spec_from_file_location(
                f"oocbench_{kind}_{name}".replace(".", "_").replace("-", "_"),
                path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            self._modules[path] = mod
        return mod

    def parts(self, name: str):
        """Cell ``name``'s entry, configuration, traffic mix, driver and
        reference."""
        cell = self.cell(name)
        config = self.config(cell["config"])
        return (cell, config, self.traffic(cell["traffic"]),
                self.module("drivers", config["entry"]),
                self.module("reference", config["entry"]))

    def metrics(self, cell: str, traced: bool) -> List[dict]:
        """The cell's end-to-end metrics (``traced`` False) or per-layer
        metrics (``traced`` True): every entry without ``workloads``, and
        those whose ``workloads`` list the cell."""
        entries = self.data["per_layer" if traced else "end_to_end"]
        return [m for m in entries if cell in m.get("workloads", [cell])]
