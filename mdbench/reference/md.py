"""Plain velocity-Verlet NVE and Maxwell-Boltzmann start, for the reference.

Units: Angstrom, fs, eV, amu (the paper's). The constants are physical
ones, written out here. The start draws its normal deviates from a CPU
``torch.Generator`` seeded with the call's seed: the documented start of the
system under test (velocities ~ N(0, kB T / m), the centre-of-mass drift
removed), worked out again from the seed.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch

from mdbench.reference.shared import neighbor_table

KB_EV = 8.617333262e-5            # Boltzmann constant, eV / K
FORCE_TO_ACC = 9.64853329045e-3   # (eV / A) / amu in A / fs^2
MASS_AMU = {"Cu": 63.546, "O": 15.999, "H": 1.008}


def masses(type_map, typ: np.ndarray) -> np.ndarray:
    return np.array([MASS_AMU[t] for t in type_map])[typ]


def start_velocities(seed: int, mass: torch.Tensor, temp_k: float
                     ) -> torch.Tensor:
    """(N, 3) float32 velocities at ``temp_k`` from ``seed``."""
    n = mass.shape[0]
    noise = torch.randn((n, 3), generator=torch.Generator().manual_seed(seed),
                        dtype=torch.float32).to(mass.device)
    v = noise * torch.sqrt(KB_EV * temp_k / mass * FORCE_TO_ACC)[:, None]
    mom = torch.sum(v * mass[:, None], dim=0)
    return v - mom / torch.sum(mass)


def kinetic(vel: torch.Tensor, mass: torch.Tensor) -> float:
    return float(0.5 * torch.sum(mass.double()[:, None] * vel.double() ** 2)
                 / FORCE_TO_ACC)


@dataclasses.dataclass
class Trajectory:
    pe: np.ndarray          # (steps,) eV, after each step
    ke: np.ndarray          # (steps,) eV
    pos: torch.Tensor       # (N, 3) after the last step
    vel: torch.Tensor
    rebuilds: int


def nve(model, pos: torch.Tensor, vel: torch.Tensor,
        typ: torch.Tensor, box: torch.Tensor, mass: torch.Tensor,
        dt_fs: float, steps: int, skin: float) -> Trajectory:
    """``steps`` velocity-Verlet steps of ``model``, a model family's
    ``Reference``. The neighbour table holds every pair within rcut + skin
    and is built again as soon as an atom has moved more than skin / 2 since
    the last build, so no pair within rcut is ever missed."""
    rc = model.rcut + skin
    nbr = neighbor_table(pos, box, rc)
    anchor = pos.clone()
    rebuilds = 0
    _, force = model.energy_forces(pos, typ, box, nbr)
    acc = FORCE_TO_ACC / mass[:, None]
    pe: List[float] = []
    ke: List[float] = []
    for _ in range(steps):
        vel = vel + 0.5 * dt_fs * acc * force
        pos = torch.remainder(pos + dt_fs * vel, box)
        moved = pos - anchor
        moved = moved - box * torch.round(moved / box)
        if float(torch.sum(moved * moved, dim=-1).max()) > (0.5 * skin) ** 2:
            nbr = neighbor_table(pos, box, rc)
            anchor = pos.clone()
            rebuilds += 1
        e, force = model.energy_forces(pos, typ, box, nbr)
        vel = vel + 0.5 * dt_fs * acc * force
        pe.append(e)
        ke.append(kinetic(vel, mass))
    return Trajectory(np.asarray(pe), np.asarray(ke), pos, vel, rebuilds)


def energy_at(model, pos: torch.Tensor, typ: torch.Tensor,
              box: torch.Tensor, skin: float = 0.0) -> Tuple[float, torch.Tensor]:
    """Potential energy at ``pos``, and the neighbour table it used."""
    nbr = neighbor_table(pos, box, model.rcut + skin)
    e, _ = model.energy_forces(pos, typ, box, nbr, forces=False)
    return e, nbr
