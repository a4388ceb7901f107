"""What the harness finds by name: BENCHMARK.json, and the files of each
configuration, traffic mix, metric and kernel.

Every piece lives in a file of its own, so a cell, a configuration, a
traffic mix, a metric or a kernel work table is added by adding files and
entries, never by editing one:

- ``configs/<config>.json``: the configuration as it is run (the file
  that BENCHMARK.json's configuration entry names);
- ``traffic/<traffic>.json``: the job kind and its parameters;
- ``metrics/<metric>.py``: a reader, ``read(run) -> float | None``;
- ``kernels/*.json``: the work of one kernel instantiation, keyed by its
  symbol as the profiler names it;
- ``peaks.json``: the published peaks of each device kind.
"""

from __future__ import annotations

import glob
import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _read_json(path: str):
    with open(path) as f:
        return json.load(f)


class Benchmark:
    """BENCHMARK.json and the files it names, under `root`."""

    def __init__(self, root: str = ROOT):
        self.root = root
        self.here = os.path.join(root, "benchmark")
        self.spec = _read_json(os.path.join(root, "BENCHMARK.json"))

    def cell(self, name: str) -> dict:
        for cell in self.spec["workloads"]:
            if cell["name"] == name:
                return cell
        raise KeyError(f"no workload named {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for entry in self.spec["configs"]:
            if entry["name"] == name:
                return _read_json(os.path.join(self.root, entry["file"]))
        raise KeyError(f"no configuration named {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return _read_json(os.path.join(self.here, "traffic", f"{name}.json"))

    def metrics(self, cell: dict, trace: bool) -> list[dict]:
        """The cell's end-to-end metrics (trace off) or per-layer metrics
        (trace on): those that list the cell, or list no cells and move an
        end-to-end metric that the cell reports."""
        e2e = [m for m in self.spec["end_to_end"] if _covers(m, cell)]
        if not trace:
            return e2e
        names = {m["name"] for m in e2e}
        return [m for m in self.spec["per_layer"]
                if _covers(m, cell) if "workloads" in m or m["moves"] in names]

    def reader(self, metric: str):
        """The module of metrics/<metric>.py."""
        path = os.path.join(self.here, "metrics", f"{metric}.py")
        spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module

    def kernels(self) -> dict:
        """Every kernel work entry by symbol; a symbol named twice raises."""
        table = {}
        for path in sorted(glob.glob(os.path.join(self.here, "kernels", "*.json"))):
            entry = _read_json(path)
            if entry["symbol"] in table:
                raise ValueError(f"kernel symbol {entry['symbol']!r} has two work entries")
            table[entry["symbol"]] = dict(entry, file=os.path.basename(path))
        return table

    def peaks(self, kind: str):
        """The published peaks of device `kind`, or None."""
        return _read_json(os.path.join(self.here, "peaks.json")).get(kind)


def _covers(metric: dict, cell: dict) -> bool:
    return "workloads" not in metric or cell["name"] in metric["workloads"]
