"""A model family that lives only in a test's copy of ``mdbench/``: a shifted
Lennard-Jones pair potential, the port's ``md/api.LJPotential``. Each entry
of ``FILES`` is written under the copy's root as it stands; no file of the
harness changes for it."""

from __future__ import annotations

REFERENCE = '''\
"""A shifted Lennard-Jones pair potential (one type): for each pair within
rcut_lj, 4 eps ((sigma / r)^12 - (sigma / r)^6) less its value at rcut_lj.
The parameters are the configuration's; the family has no weights."""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from mdbench.reference.shared import round_tf32


def weights(cfg: Dict, seed: int, device: torch.device,
            dstd: Optional[torch.Tensor] = None) -> Dict:
    return {}


class Reference:
    def __init__(self, cfg: Dict, weights: Dict, device: torch.device,
                 precision: str = "float32"):
        self.rcut = float(cfg["rcut_lj"])
        self.ntypes = 1
        self.eps, self.sigma = float(cfg["epsilon"]), float(cfg["sigma"])
        self.precision = precision

    def _pair(self, r2: torch.Tensor) -> torch.Tensor:
        sr6 = (self.sigma ** 2 / r2) ** 3
        sc6 = (self.sigma / self.rcut) ** 6
        return 4.0 * self.eps * (sr6 * sr6 - sr6 - (sc6 * sc6 - sc6))

    def energy_forces(self, pos: torch.Tensor, typ: torch.Tensor,
                      box: torch.Tensor, nbr: torch.Tensor,
                      forces: bool = True
                      ) -> Tuple[float, Optional[torch.Tensor]]:
        valid = nbr >= 0
        j = torch.clamp(nbr, min=0)
        rij = pos[j] - pos[:, None, :]
        rij = rij - box * torch.round(rij / box)
        if self.precision == "tf32":
            rij = round_tf32(rij)
        rij.requires_grad_(forces)
        with torch.enable_grad():
            r2 = torch.sum(rij * rij, dim=-1)
            live = valid & (r2 < self.rcut ** 2)
            e = 0.5 * torch.where(live,
                                  self._pair(torch.where(live, r2, 1.0)),
                                  0.0)
        total = float(e.detach().double().sum())
        if not forces:
            return total, None
        (g,) = torch.autograd.grad(e.sum(), rij)
        force = torch.zeros_like(pos)
        force.index_add_(0, j.reshape(-1), -g.reshape(-1, 3))
        return total, force + g.sum(dim=1)


def force_eval_flops(cfg: Dict, atoms: int, live_pairs: float) -> float:
    """Per live pair: r^2, its powers and the pair energy (15), the
    gradient with its action and reaction (21)."""
    return 36.0 * live_pairs
'''

ENTRY = '''\
"""The single-card entry with the port's Lennard-Jones potential: the
simulation entry's calls, another potential."""

from pathlib import Path

from mdbench import manifest

Simulation = manifest.entry_class("simulation",
                                  Path(__file__).resolve().parents[1])


class Entry(Simulation):
    def __init__(self, run):
        from repro_torch.md import api

        self._api = api
        self.run = run
        self.potential = manifest.config_for(api.LJPotential,
                                             run.cell.config)
        self.params = {}
'''

CONFIG = {"name": "lj_cu", "source": "test", "family": "lj",
          "epsilon": 0.4, "sigma": 2.277, "rcut_lj": 4.0, "sel": [48],
          "type_map": ["Cu"], "model_seed": 0}

FILES = {"reference/lj.py": REFERENCE, "entries/lj.py": ENTRY}
