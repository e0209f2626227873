"""What a cell is made of, found by name.

``BENCHMARK.json`` at the root of the checkout lists the cells and the
metrics.  Everything that belongs to one configuration, one traffic mix or
one per-layer metric sits in a file of its own under ``benchmark/``:

- ``configs/<config>.json``: the problem, its depth and the keys of the
  program's ``SearchConfig`` that differ from the defaults, with the
  source, the cut, the reference's counts and points, and the limits of
  the comparison that decides ``correct``;
- ``traffic/<traffic>.json``: the keys the mix adds and whether the
  report runs its family pass;
- ``metrics/<metric>.py``: a ``read(record)`` that returns the metric's
  value from a traced run's record, or None when it finds nothing.

Adding a cell, a configuration, a mix or a metric adds files and entries;
no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass
from typing import Callable, List

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]

    @property
    def problem(self) -> str:
        return self.config["problem"]

    @property
    def depth(self) -> int:
        return int(self.config["max_depth"])

    def search_keys(self) -> dict:
        """``SearchConfig`` keys of the cell: the configuration's, then the
        mix's."""
        keys = dict(self.config.get("search_config", {}))
        keys.update(self.traffic.get("search_config", {}))
        keys["max_depth"] = self.depth
        return keys

    @property
    def report_families(self) -> bool:
        """The report's family pass and SymPy classing of the valid rows
        (``--no-report-families`` turns them off)."""
        return bool(self.traffic.get("report_families", True))

    @property
    def warmup_depth(self) -> int:
        """The set-up's run goes one depth short of the window's."""
        return self.depth - 1


def applies(metric: dict, cell_name: str) -> bool:
    return cell_name in metric.get("workloads", [cell_name])


def load_cell(name: str, bench: dict = None, bench_dir: str = BENCH_DIR) -> Cell:
    bench = bench if bench is not None else load_json(
        os.path.join(os.path.dirname(bench_dir), "BENCHMARK.json"))
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have: {', '.join(work)})")
    w = work[name]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg_file = os.path.join(os.path.dirname(bench_dir),
                            configs[w["config"]]["file"])
    traffic = load_json(os.path.join(bench_dir, "traffic",
                                     w["traffic"] + ".json"))
    end_to_end = [m for m in bench["end_to_end"] if applies(m, name)]
    # a per-layer metric belongs to the cells that report what it moves
    reported = {m["name"] for m in end_to_end}
    return Cell(
        name=name, chips=int(w["chips"]), config=load_json(cfg_file),
        traffic=traffic, end_to_end=end_to_end,
        per_layer=[m for m in bench["per_layer"]
                   if applies(m, name) and m["moves"] in reported])


def metric_reader(name: str, bench_dir: str = BENCH_DIR) -> Callable:
    """``read`` of ``metrics/<name>.py``."""
    path = os.path.join(bench_dir, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read

