"""Package boundaries of the port: it imports neither JAX nor the reference
package, its entry points default to the card and refuse a missing one, every part
of the reference's single-process surface runs, and ``chip_smoke.py``
refuses to run without a card or without the repository around it."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import bridge, configs
from repro_torch.core import dp_model
from repro_torch.core.types import DPConfig
from repro_torch.launch import serve_lm
from repro_torch.md import api, cli, driver, lattice
from repro_torch.models import build
from repro_torch.train import cli as train_cli
from repro_torch.train import dp_trainer

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
             or m == "repro" or m.startswith("repro.") or m == "ml_dtypes")
print(len(names), bad)
"""


def test_port_imports_neither_jax_nor_reference():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL],
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert out.returncode == 0, out.stderr
    n, bad = out.stdout.strip().split(" ", 1)
    assert int(n) >= 65 and bad == "[]", out.stdout


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
    lj = api.make_potential("lj")
    for engine in ("python", "scan", "outer"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            api.Simulation(api.SimulationSpec(lj, engine=engine)).run(
                {}, *lattice.fcc_copper(3, 3, 3))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        driver.run_md(TINY, params, pos, typ, box)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["--potential", "lj"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dp_trainer.train_dp(TINY, steps=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dp_trainer.teacher_data(TINY, params, n_configs=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_cli.main(["--steps", "1"])
    for arch in configs.all_archs():
        lm = build(configs.get_reduced(arch))
        with pytest.raises(RuntimeError, match="device='cpu'"):
            lm.init(gen)
        lm_params = lm.init(torch.Generator().manual_seed(0), device="cpu")
        assert lm_params["embed"].device.type == "cpu"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_lm.main(["--arch", "qwen3-1.7b"])


def _run(spec, params=None, nx=2):
    pos, typ, box = lattice.fcc_copper(nx, nx, nx)
    return api.Simulation(spec).run({} if params is None else params, pos,
                                    typ, box, device="cpu")


def _dp(impl=None):
    pot = api.make_potential("dp", TINY, impl=impl)
    return pot, pot.init_params(torch.Generator().manual_seed(0),
                                device="cpu")


_LJ = api.LJPotential(sel=(48,), rcut_lj=4.0)
_SHORT = dict(steps=4, rebuild_every=2, skin=0.5)

# Every call that the port refused or lacked before its last slices
# (ROADMAP.md §A.7-§A.10, §A.13) now runs on the CPU: the quintic rung, the
# python and outer engines, LJ, Langevin, Berendsen, the barostats and
# pressure_gpa, the run_md shim and the CLI; the DP trainer and its CLI.
_FORMERLY_REFUSED = {
    "make_potential_quintic": lambda: _run(api.SimulationSpec(
        api.make_potential("quintic", TINY), **_SHORT),
        api.make_potential("quintic", TINY).init_params(
            torch.Generator().manual_seed(0), device="cpu")),
    "dp_impl_quintic": lambda: _run(api.SimulationSpec(
        _dp("quintic")[0], **_SHORT), _dp("quintic")[1]),
    "tabulated_default_kind": lambda: api.TabulatedDPPotential(TINY)
    .init_params(torch.Generator().manual_seed(0), device="cpu"),
    "tabulate_model_quintic": lambda: dp_model.tabulate_model(
        _dp()[1], TINY, "quintic"),
    "lj": lambda: _run(api.SimulationSpec(api.make_potential("lj"),
                                          **_SHORT), nx=3),
    "nvt_langevin": lambda: _run(api.SimulationSpec(
        _LJ, ensemble="nvt_langevin", **_SHORT)),
    "berendsen": lambda: _run(api.SimulationSpec(
        _LJ, ensemble="berendsen", **_SHORT)),
    "npt_berendsen": lambda: _run(api.SimulationSpec(
        _LJ, ensemble="npt_berendsen", **_SHORT)),
    "npt_scr": lambda: _run(api.SimulationSpec(
        _LJ, ensemble="npt_scr", **_SHORT)),
    "pressure_gpa": lambda: _run(api.SimulationSpec(
        _LJ, pressure_gpa=1.0, **_SHORT)),
    "engine_python": lambda: _run(api.SimulationSpec(
        _dp()[0], engine="python", **_SHORT), _dp()[1]),
    "engine_outer": lambda: _run(api.SimulationSpec(
        _dp()[0], engine="outer", **_SHORT), _dp()[1]),
    "run_md": lambda: driver.run_md(TINY, _dp()[1],
                                    *lattice.fcc_copper(2, 2, 2),
                                    device="cpu", **_SHORT),
    "cli": lambda: cli.main(["--device", "cpu", "--nx", "2", "--steps", "3",
                             "--engine", "outer", "--potential", "lj",
                             "--ensemble", "npt_scr"]),
    "train_dp": lambda: dp_trainer.train_dp(TINY, steps=3, n_configs=4,
                                            verbose=False, device="cpu"),
    "train_cli_copper": lambda: train_cli.main(
        ["--system", "copper", "--device", "cpu", "--steps", "3"]),
    "train_cli_water": lambda: train_cli.main(
        ["--system", "water", "--device", "cpu", "--steps", "3"]),
}


@pytest.mark.parametrize("name", sorted(_FORMERLY_REFUSED))
def test_formerly_refused_parts_run_on_the_cpu(name):
    out = _FORMERLY_REFUSED[name]()
    if name == "train_dp":
        state, log = out
        assert int(state.step) == 3 and np.isfinite(log[-1]["loss"])
    if isinstance(out, driver.MDResult):
        assert out.steps == _SHORT["steps"]
        assert np.all(np.isfinite(out.final_pos))
        assert np.isfinite(out.thermo[-1]["etot"])


def test_no_part_says_it_is_not_ported():
    """No module of the port refuses a part as not ported yet."""
    src = ROOT / "src" / "repro_torch"
    for path in src.rglob("*.py"):
        text = path.read_text()
        assert "NotImplementedError" not in text, path
        assert "not ported yet" not in text, path


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
