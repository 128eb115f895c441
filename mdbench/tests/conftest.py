"""A tiny cell for the benchmark's CPU tests: the harness's own metric
readers and entries, with a narrow DP model on 108 copper atoms."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

MDBENCH = ROOT / "mdbench"

TINY_CONFIG = {
    "name": "tiny_cu", "source": "test", "ntypes": 1, "rcut": 4.0,
    "rcut_smth": 1.0, "sel": [48], "type_map": ["Cu"],
    "embed_widths": [4, 8, 16], "axis_neuron": 4, "type_one_side": True,
    "fit_widths": [16, 16, 16], "impl": "cheb_pallas", "table_lower": -2.0,
    "table_upper": 10.0, "cheb_order": 16, "dtype": "float32",
    "model_seed": 0}

TINY_TRAFFIC = {
    "entry": "simulation",
    "system": {"kind": "fcc", "cells": [3, 3, 3], "lattice_a": 3.634},
    "ensemble": "nve", "temp_k": 330.0, "dt_fs": 1.0, "steps": 20,
    "engine": "scan", "rebuild_every": 10, "skin": 1.0, "chunk_segments": 8,
    "warmup_steps": 2, "check": {"follow_steps": 20},
    "trace": {"start_s": 0.0, "seconds": 1.0}}

# set from the tiny cell's own readings on the CPU: the port against the
# reference at most 1.3e-8 / 5.8e-9 / 3.6e-12 / 0 / 5.9e-9 over five seeds,
# the emulated TF32 control 1.9e-5 / 5e-10 / 9e-10 / 2.4e-7 / 7.8e-6 at the
# least over three
TINY_LIMITS = {"pe_rows": 1e-6, "ke_rows": 2e-8, "vel_end": 5e-9,
               "pos_end": 1e-7, "pe_end": 1e-6}
# bricks drift their atoms unwrapped and wrap them at each migration, where
# the reference wraps every step: near a face the last bits of a position
# differ by ~steps x ulp(box) (9e-6 A after 20 steps on the CPU), with
# velocities within 5e-10 A/fs. So pos_end separates nothing there, and
# vel_end carries the end of the call.
TINY_BRICK_LIMITS = {k: v for k, v in TINY_LIMITS.items() if k != "pos_end"}


@pytest.fixture
def tiny_base(tmp_path):
    """A copy of the harness's readers, entries, model families and system
    builders with the tiny cell's files; returns (BENCHMARK.json path, base
    directory)."""
    base = tmp_path / "mdbench"
    for d in ("metrics", "entries", "reference", "systems"):
        shutil.copytree(MDBENCH / d, base / d)
    for d in ("configs", "traffic", "limits"):
        (base / d).mkdir()
    (base / "configs" / "tiny_cu.json").write_text(json.dumps(TINY_CONFIG))
    (base / "traffic" / "tiny.json").write_text(json.dumps(TINY_TRAFFIC))
    (base / "traffic" / "tiny_bricks.json").write_text(json.dumps(dict(
        TINY_TRAFFIC, entry="domain", topology="2x2", engine="outer",
        system=dict(TINY_TRAFFIC["system"], cells=[4, 4, 3]))))
    for cell, limits in (("tiny", TINY_LIMITS),
                         ("tiny_bricks", TINY_BRICK_LIMITS)):
        (base / "limits" / f"{cell}.json").write_text(
            json.dumps({"limits": limits}))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"] = [{"name": "tiny_cu", "source": "test",
                         "file": "mdbench/configs/tiny_cu.json",
                         "reduced": [], "why": "test"}]
    bench["workloads"] = [{"name": "tiny", "config": "tiny_cu",
                           "traffic": "tiny", "chips": 1, "why": "test"},
                          {"name": "tiny_bricks", "config": "tiny_cu",
                           "traffic": "tiny_bricks", "chips": 4,
                           "why": "test"}]
    for m in bench["per_layer"]:
        m["workloads"] = ["tiny", "tiny_bricks"]
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    return path, base
