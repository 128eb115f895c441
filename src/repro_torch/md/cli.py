"""The paper's copper MD protocol end to end on the port:

    python -m repro_torch.md.cli [--nx 3] [--steps 99] \\
        [--engine outer|scan|python] [--potential dp|lj] \\
        [--ensemble nve|nvt_langevin|berendsen|npt_berendsen|npt_scr] \\
        [--temp 330] [--friction 0.1] [--tau 100] [--pressure P] [--ptau 500] \\
        [--device cuda|cpu]

99 velocity-Verlet steps at dt = 1 fs, Maxwell-Boltzmann start at 330 K,
neighbor list with a 2 A skin rebuilt every 50 steps, thermo every 50, built
on the ``SimulationSpec`` API. With ``--potential dp`` the implementation
ladder runs (mlp -> quintic -> cheb -> cheb_pallas, the last through the
hand-written kernels), each timed per step; ``--potential lj`` runs the
analytic Lennard-Jones instead, the engine-overhead case. Runs on the card
unless ``--device cpu`` is given. The flags are those of the reference's
``examples/md_copper.py``, plus ``--device``.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import numpy as np
import torch

from repro_torch.core.types import DPConfig
from repro_torch.device import resolve_device
from repro_torch.md import api, lattice


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.md.cli")
    ap.add_argument("--nx", type=int, default=3, help="FCC supercell edge")
    ap.add_argument("--steps", type=int, default=99)
    ap.add_argument("--engine", default="scan",
                    choices=("outer", "scan", "python"),
                    help="outer (segments with the rebuild on the device, "
                         "CUDA-graph replay on the card), scan (default) or "
                         "the per-step python loop")
    ap.add_argument("--potential", default="dp", choices=("dp", "lj"),
                    help="dp runs the implementation ladder; lj is the "
                         "analytic Lennard-Jones (no DP params)")
    ap.add_argument("--ensemble", default="nve", choices=api.ENSEMBLE_CHOICES,
                    help="npt_* names add a barostat: the box evolves in "
                         "the carry toward --pressure")
    ap.add_argument("--temp", type=float, default=330.0)
    ap.add_argument("--friction", type=float, default=0.1,
                    help="nvt_langevin friction (1/fs)")
    ap.add_argument("--tau", type=float, default=100.0,
                    help="berendsen time constant (fs)")
    ap.add_argument("--pressure", type=float, default=None,
                    help="target pressure (GPa); with a non-NPT ensemble "
                         "this attaches a Berendsen barostat")
    ap.add_argument("--ptau", type=float, default=500.0,
                    help="barostat time constant (fs)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # paper-shaped copper model, scaled down (sel 128 vs the paper's 512)
    cfg = DPConfig(ntypes=1, rcut=6.0, rcut_smth=2.0, sel=(128,),
                   type_map=("Cu",), embed_widths=(16, 32, 64), axis_neuron=8,
                   fit_widths=(64, 64, 64))
    pos, typ, box = lattice.fcc_copper(args.nx, args.nx, args.nx)
    print(f"{len(pos)} copper atoms, box {np.round(box, 2)}, "
          f"ensemble {args.ensemble}, device {dev}")
    ensemble, barostat = api.resolve_ensemble(
        args.ensemble, temp_k=args.temp, friction=args.friction,
        tau_fs=args.tau, pressure_gpa=args.pressure, ptau_fs=args.ptau)

    if args.potential == "lj":
        ladder = [("lj", api.LJPotential(sel=cfg.sel, rcut_lj=cfg.rcut), {})]
    else:
        params = api.DPPotential(cfg).init_params(
            torch.Generator().manual_seed(0), device=dev)
        ladder = [("mlp", api.make_potential("dp", cfg), params)]
        for impl in ("quintic", "cheb", "cheb_pallas"):
            pot = api.make_potential("dp", cfg, impl=impl)
            ladder.append((impl, pot, pot.prepare_params(params)))

    base = None
    for name, pot, params in ladder:
        sim = api.Simulation(api.SimulationSpec(
            potential=pot, ensemble=ensemble, steps=args.steps, dt_fs=1.0,
            temp_k=args.temp, engine=args.engine, barostat=barostat))
        res = sim.run(params, pos, typ, box, device=dev)
        drift = abs(res.thermo[-1]["etot"] - res.thermo[0]["etot"])
        if base is None:
            base = res.us_per_step_atom
        extra = ""
        if barostat is not None:
            extra = (f"  P_final {res.thermo[-1]['press_gpa']:+.2f} GPa "
                     f"box_x {res.final_box[0]:.3f} A")
        print(f"impl={name:11s} engine={res.engine:6s} "
              f"{res.us_per_step_atom:8.2f} us/step/atom "
              f"(speedup {base / res.us_per_step_atom:4.1f}x)  "
              f"drift {drift:.2e} eV  T_final {res.thermo[-1]['temp']:.0f} K"
              + extra)


if __name__ == "__main__":
    main()
