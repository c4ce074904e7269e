"""``BENCHMARK.json`` and what it names, found by name: a cell's
configuration (the file its entry names), its traffic mix
(``traffic/<name>.json``) and each metric's reader (``metrics/<name>.py``,
or, for a name with a suffix such as ``h2d_ms.offline``, the file of its
first part, ``metrics/h2d_ms.py``)."""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

from . import traffic as traffic_mod

HERE = Path(__file__).resolve().parent
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")


class Manifest:
    def __init__(self, path: Path):
        self.path = path
        self.root = path.parent
        self.doc = json.loads(path.read_text())
        self.configs = {c["name"]: c for c in self.doc["configs"]}
        self.cells = {w["name"]: w for w in self.doc["workloads"]}

    def cell(self, name: str) -> dict:
        if name not in self.cells:
            raise KeyError(f"no workload {name!r} in {self.path}; have "
                           f"{sorted(self.cells)}")
        return self.cells[name]

    def config(self, cell: dict) -> dict:
        entry = self.configs[cell["config"]]
        return json.loads((self.root / entry["file"]).read_text())

    def traffic(self, cell: dict) -> traffic_mod.Traffic:
        return traffic_mod.load(cell["traffic"])

    def metrics(self, cell: dict, traced: bool) -> list[dict]:
        """The metrics the cell reports: with ``traced`` the per-layer ones,
        else the end-to-end ones; a metric without ``workloads`` is every
        cell's."""
        group = self.doc["per_layer" if traced else "end_to_end"]
        return [m for m in group
                if cell["name"] in m.get("workloads", [cell["name"]])]


def reader(name: str, root: Path = HERE):
    """The ``read(run)`` function of a metric, from its file."""
    for stem in (name, name.split(".")[0]):
        path = root / "metrics" / f"{stem}.py"
        if path.exists():
            spec = importlib.util.spec_from_file_location(
                "portbench.metrics." + stem.replace(".", "_"), path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod.read
    raise FileNotFoundError(f"no reader for metric {name!r} under "
                            f"{root / 'metrics'}")
