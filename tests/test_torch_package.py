"""Package boundaries of the port: it imports neither JAX nor the reference
package, its entry points default to the card and refuse a missing one,
the parts not ported yet say so, and ``chip_smoke.py`` refuses to run
without a card or without the repository around it."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.core import dp_model
from repro_torch.core.types import DPConfig
from repro_torch.md import api, lattice

ROOT = Path(__file__).resolve().parents[1]
TINY = DPConfig(ntypes=1, rcut=4.0, rcut_smth=2.0, sel=(48,),
                type_map=("Cu",), embed_widths=(8, 16, 32), axis_neuron=4,
                fit_widths=(24, 24, 24), table_lower=-1.0, table_upper=9.0)

_IMPORT_ALL = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "repro" or m.startswith("repro."))
print(len(names), bad)
"""


def test_port_imports_neither_jax_nor_reference():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL],
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert out.returncode == 0, out.stderr
    n, bad = out.stdout.strip().split(" ", 1)
    assert int(n) >= 17 and bad == "[]", out.stdout


def test_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dp_model.init_dp_params(gen, TINY)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bridge.params_from_numpy({"dstd": np.ones((1, 4), np.float32)})
    pot = api.make_potential("dp", TINY, impl="cheb_pallas")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pot.init_params(gen)
    params = pot.init_params(gen, device="cpu")
    assert params["table"]["nets"]["0"]["coeffs"].device.type == "cpu"
    pos, typ, box = lattice.fcc_copper(2, 2, 2)
    sim = api.Simulation(api.SimulationSpec(pot, steps=2))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sim.run(params, pos, typ, box)
    assert sim.run(params, pos, typ, box, device="cpu").steps == 2


def test_parts_not_ported_yet_say_where_they_wait():
    pot = api.make_potential("dp", TINY)
    cases = [
        lambda: api.make_potential("quintic", TINY),
        lambda: api.make_potential("dp", TINY, impl="quintic"),
        lambda: api.TabulatedDPPotential(TINY),
        lambda: api.make_potential("lj"),
        lambda: api.SimulationSpec(pot, ensemble="nvt_langevin"),
        lambda: api.SimulationSpec(pot, ensemble="berendsen"),
        lambda: api.SimulationSpec(pot, ensemble="npt_scr"),
        lambda: api.SimulationSpec(pot, pressure_gpa=1.0),
        lambda: dp_model.tabulate_model({}, TINY, "quintic"),
    ]
    for engine in ("python", "outer"):
        spec = api.SimulationSpec(pot, engine=engine)
        cases.append(lambda spec=spec: api.Simulation(spec).run(
            {}, np.zeros((1, 3)), np.zeros(1, np.int32), np.ones(3),
            device="cpu"))
    for case in cases:
        with pytest.raises(NotImplementedError, match=r"ROADMAP\.md §A\."):
            case()


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """No result line and a non-zero exit: on this CPU-only machine, and in
    a directory that holds chip_smoke.py and nothing else of the repo
    (where, given a card, the port itself is missing)."""
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", alone)
    for script in (ROOT / "chip_smoke.py", alone):
        out = subprocess.run([sys.executable, str(script)],
                             capture_output=True, text=True, timeout=120,
                             cwd=script.parent,
                             env=dict(os.environ, PYTHONPATH=""))
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
