"""Everything a run needs, found by name: the cell in ``BENCHMARK.json``,
its configuration file, its traffic mix and the readers of its metrics
(``wolbench/metrics/<metric>.py``)."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

from wolbench.traffic import generator

__all__ = ["ROOT", "BENCH_DIR", "load_benchmark", "Cell", "find_cell",
           "reader"]

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


class Cell:
    """One workload: its entry, configuration, traffic mix and metrics."""

    def __init__(self, bench: dict, name: str, root: Path = ROOT):
        by_name = {w["name"]: w for w in bench["workloads"]}
        if name not in by_name:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.entry = by_name[name]
        self.name = name
        conf = {c["name"]: c for c in bench["configs"]}[self.entry["config"]]
        self.config = json.loads((root / conf["file"]).read_text())
        self.mix = generator.load(self.entry["traffic"])
        self.chips = int(self.entry["chips"])
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in bench["per_layer"]
                          if name in m.get("workloads", [name])]


def find_cell(name: str, root: Path = ROOT) -> Cell:
    return Cell(load_benchmark(root), name, root)


def reader(metric: str):
    """The ``read(ctx)`` of ``wolbench/metrics/<metric>.py`` or, where the
    metric has no file of its own, of its quantity's file: the name up to
    its first dot (``device_idle_pct.xc`` -> ``device_idle_pct.py``).  A
    reader returns None where it finds nothing to read."""
    for stem in dict.fromkeys((metric, metric.split(".", 1)[0])):
        path = BENCH_DIR / "metrics" / f"{stem}.py"
        if path.is_file():
            break
    else:
        raise KeyError(f"no reader for metric {metric!r} ({path.name})")
    spec = importlib.util.spec_from_file_location(
        f"wolbench_metric_{stem.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
