"""Train a Deep Potential model against teacher labels, then check that the
compressed (quintic-tabulated) model matches the trained one:

    python -m repro_torch.train.cli [--system copper|water] [--steps 300] \\
        [--device cuda|cpu]

The port's counterpart of the reference's ``examples/train_dp.py``, with its
two tiny configurations and flow: train 16 teacher-labelled configurations
in minibatches of 4 (E+F loss, DeePMD prefactor schedule, exp-decay LR),
tabulate the trained embedding nets, and print the largest energy and force
differences against the ``mlp`` rung on held-out configurations (seed 99).
Runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

from repro_torch.core import dp_model
from repro_torch.core.types import DPConfig
from repro_torch.device import resolve_device
from repro_torch.train.dp_trainer import (batch_energy_forces, teacher_data,
                                          train_dp)


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.train.cli")
    ap.add_argument("--system", choices=("copper", "water"), default="copper")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    if args.system == "copper":
        cfg = DPConfig(ntypes=1, rcut=4.0, rcut_smth=2.0, sel=(48,),
                       type_map=("Cu",), embed_widths=(8, 16, 32),
                       axis_neuron=4, fit_widths=(32, 32, 32))
    else:
        cfg = DPConfig(ntypes=2, rcut=4.0, rcut_smth=0.5, sel=(16, 32),
                       type_map=("O", "H"), embed_widths=(8, 16, 32),
                       axis_neuron=4, fit_widths=(32, 32, 32))
    state, _ = train_dp(cfg, steps=args.steps, n_configs=16, batch_size=4,
                        system=args.system, log_every=50, device=dev)

    # compress the trained model and check the tabulation error
    params = state.params
    ptab = dp_model.tabulate_model(params, cfg, "quintic")
    data = teacher_data(cfg, params, n_configs=2, system=args.system,
                        seed=99, device=dev)
    e0, f0 = batch_energy_forces(params, cfg, data, impl="mlp")
    e1, f1 = batch_energy_forces(ptab, cfg, data, impl="quintic")
    print(f"tabulated-vs-trained: dE {float((e1 - e0).abs().max()):.2e} eV, "
          f"dF {float((f1 - f0).abs().max()):.2e} eV/A")


if __name__ == "__main__":
    main()
