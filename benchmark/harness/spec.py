"""What one cell runs, found by name: the cell in ``BENCHMARK.json``, its
configuration ``configs/<config>.json``, its traffic mix
``traffic/<traffic>.json``, its limits ``limits/<cell>.json`` and the
readers ``metrics/<metric>.py`` of the per-layer metrics that list it.
Adding a cell, a mix or a metric adds files and entries; no code here
names one."""

from __future__ import annotations

import copy
import importlib.util
import json
import os
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


@dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    traffic_name: str
    config: Dict[str, Any]          # configs/<config>.json
    traffic: Dict[str, Any]         # traffic/<traffic>.json
    limits: Dict[str, Any]          # limits/<cell>.json
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]
    readers: Dict[str, Callable] = field(default_factory=dict)

    @property
    def trainer(self) -> str:
        return self.traffic["trainer"]

    def trainer_cfg(self, seed: int, logdir: str) -> Dict[str, Any]:
        """The port's config tree for this cell: the configuration's env
        and the trainer section that the mix names, with the mix's batch
        settings, ``seed`` and ``logdir``, and no checkpoints."""
        section = copy.deepcopy(self.config["trainers"][self.trainer])
        params = {"diff_env": copy.deepcopy(self.config["diff_env"]),
                  "general": {"seed": int(seed), "logdir": logdir}}
        params.update(section)
        params["config"].update(self.traffic.get("config", {}))
        params["config"].update(save_interval=0, save_frequency=0)
        return {"params": params}


def _load_json(path):
    with open(path) as f:
        return json.load(f)


def load_reader(path) -> Callable:
    """The ``read`` function of a metric reader file."""
    name = "benchmark_metric_" + os.path.basename(path)[:-3].replace(
        ".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def _applies(metric, cell_name):
    cells = metric.get("workloads")
    return cells is None or cell_name in cells


def load_cell(name: str, root: str = ROOT) -> Cell:
    """The cell ``name`` of ``<root>/BENCHMARK.json`` with its files."""
    bench = _load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                       f"have {sorted(cells)}")
    w = cells[name]
    base = os.path.join(root, "benchmark")
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    cell = Cell(
        name=name, chips=int(w["chips"]), config_name=w["config"],
        traffic_name=w["traffic"],
        config=_load_json(os.path.join(root, cfg_entry["file"])),
        traffic=_load_json(os.path.join(base, "traffic",
                                        w["traffic"] + ".json")),
        limits=_load_json(os.path.join(base, "limits", name + ".json")),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)])
    for m in cell.per_layer:
        cell.readers[m["name"]] = load_reader(
            os.path.join(base, "metrics", m["name"] + ".py"))
    return cell
