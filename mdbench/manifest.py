"""Finds everything of a cell by the names in ``BENCHMARK.json`` and in its
files, all in the directory the cell was read from (``Cell.base``).

  configs/<config>.json      a model configuration: its model family
                             (``"family"``, se_e2_a where absent), the
                             fields of the port's model config, its source
                             and what was assumed
  traffic/<traffic>.json     a run protocol: the entry, the system, the
                             ensemble and engine, steps a call, the check's
                             length and the traced stretch
  limits/<cell>.json         the limit of each number the check compares
  metrics/<metric>.py        the reader of one metric: ``read(run)`` returns
                             its value, or None where it finds nothing
  entries/<entry>.py         the code that drives one kind of entry of the
                             port (``Entry(run)``)
  reference/<family>.py      a model family: ``weights(cfg, seed, device,
                             dstd)``, the plain ``Reference(cfg, weights,
                             device, precision)`` and ``force_eval_flops(cfg,
                             atoms, live_pairs)``
  systems/<kind>.py          a system's builder (the traffic's
                             ``system.kind``): ``build(spec) -> (pos, typ,
                             box)``

A new cell, configuration, model family, system or metric is new files here
and new entries in ``BENCHMARK.json``; no file that is already here changes.
(``reference/md.py`` and ``reference/shared.py`` are no families.)
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
    family: Any                     # its model family: reference/<family>.py
    base: Path = HERE               # the directory its files were read from


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
    config = _json(base / "configs" / f"{w['config']}.json")
    return Cell(name=cell, chips=int(w["chips"]), config_name=w["config"],
                config=config,
                traffic_name=w["traffic"],
                traffic=_json(base / "traffic" / f"{w['traffic']}.json"),
                limits=_json(limits_path)["limits"]
                if limits_path.exists() else {},
                end_to_end=metrics("end_to_end"),
                per_layer=metrics("per_layer"),
                family=family(config, base), base=base)


DEFAULT_FAMILY = "se_e2_a"


def family(cfg: Dict, base: Path = HERE):
    """The module ``reference/<family>.py`` of configuration ``cfg``."""
    name = cfg.get("family", DEFAULT_FAMILY)
    return _load_module(base / "reference" / f"{name}.py",
                        f"mdbench_family_{name}")


def system_builder(kind: str, base: Path = HERE):
    """The module ``systems/<kind>.py``."""
    return _load_module(base / "systems" / f"{kind}.py",
                        f"mdbench_system_{kind}")


def config_for(cls, cfg: Dict):
    """``cls`` (a dataclass: the port's model config) built from every key
    of the configuration file that is one of its fields, lists made
    tuples."""
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: tuple(v) if isinstance(v, list) else v
                  for k, v in cfg.items() if k in names})
