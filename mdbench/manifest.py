"""Finds everything of a cell by the names in ``BENCHMARK.json``.

  configs/<config>.json      a model configuration (the port's DPConfig
                             fields, its source and what was assumed)
  traffic/<traffic>.json     a run protocol: the entry, the system, the
                             ensemble and engine, steps a call, the check's
                             length and the traced stretch
  limits/<cell>.json         the limit of each number the check compares
  metrics/<metric>.py        the reader of one metric: ``read(run)`` returns
                             its value, or None where it finds nothing
  entries/<entry>.py         the code that drives one kind of entry of the
                             port (``Entry(run)``)

A new cell, configuration or metric is new files here and new entries in
``BENCHMARK.json``; no file that is already here changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Any, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Metric:
    name: str
    unit: str
    better: str
    source: str
    kind: str                      # "end_to_end" or "per_layer"
    workloads: Optional[List[str]]
    module: Any                    # its reader: ``read(run)``, and
    #                                optionally ``measure(run)``, which runs
    #                                on a traced run after the window, while
    #                                the port's state still lives

    def read(self, run) -> Optional[float]:
        return self.module.read(run)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: Dict
    traffic_name: str
    traffic: Dict
    limits: Dict[str, float]
    end_to_end: List[Metric]
    per_layer: List[Metric]


def _json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def _load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(name: str, base: Path = HERE):
    return _load_module(base / "metrics" / f"{name}.py",
                        f"mdbench_metric_{name}")


def entry_class(name: str, base: Path = HERE):
    return _load_module(base / "entries" / f"{name}.py",
                        f"mdbench_entry_{name}").Entry


def load(cell: str, benchmark: Optional[Path] = None,
         base: Path = HERE) -> Cell:
    """The cell named ``cell`` of ``benchmark`` (the repository's
    ``BENCHMARK.json`` by default), its files read from ``base``."""
    bench = _json(benchmark or ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if cell not in cells:
        raise KeyError(f"no workload {cell!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[cell]

    def metrics(kind: str) -> List[Metric]:
        out = []
        for m in bench[kind]:
            where = m.get("workloads")
            if where is not None and cell not in where:
                continue
            out.append(Metric(m["name"], m["unit"], m["better"], m["source"],
                              kind, where, reader(m["name"], base)))
        return out

    limits_path = base / "limits" / f"{cell}.json"
    return Cell(name=cell, chips=int(w["chips"]), config_name=w["config"],
                config=_json(base / "configs" / f"{w['config']}.json"),
                traffic_name=w["traffic"],
                traffic=_json(base / "traffic" / f"{w['traffic']}.json"),
                limits=_json(limits_path)["limits"]
                if limits_path.exists() else {},
                end_to_end=metrics("end_to_end"),
                per_layer=metrics("per_layer"))


def dp_config_fields(cfg: Dict) -> Dict:
    """The configuration file's fields that the port's ``DPConfig`` takes."""
    keys = ("ntypes", "rcut", "rcut_smth", "sel", "type_map", "embed_widths",
            "axis_neuron", "type_one_side", "fit_widths", "impl",
            "table_lower", "table_upper", "cheb_order", "dtype")
    out = {k: cfg[k] for k in keys if k in cfg}
    for k in ("sel", "type_map", "embed_widths", "fit_widths"):
        out[k] = tuple(out[k])
    return out
