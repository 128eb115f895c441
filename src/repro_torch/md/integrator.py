"""Velocity-Verlet integrator + thermodynamics (paper Sec. 4 protocol).

Units: Angstrom, fs, eV, amu. The paper runs NVE after Maxwell-Boltzmann
velocity initialization at 330 K, 99 steps, neighbor rebuild every 50 steps,
thermo output every 50 steps — the driver reproduces that protocol.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

KB_EV = 8.617333262e-5            # eV / K
# (eV/A)/amu in A/fs^2
FORCE_TO_ACC = 9.64853329045e-3
# 1 eV/A^3 in GPa (pressure/stress unit conversion)
EV_A3_TO_GPA = 160.21766208


class MDState(NamedTuple):
    pos: torch.Tensor       # (N, 3) A
    vel: torch.Tensor       # (N, 3) A/fs
    force: torch.Tensor     # (N, 3) eV/A
    step: torch.Tensor      # () int32


def _weights(n: int, like: torch.Tensor,
             amask: Optional[torch.Tensor]) -> torch.Tensor:
    if amask is not None:
        return amask.to(like.dtype)
    return torch.ones(n, dtype=like.dtype, device=like.device)


def init_velocities(gen: torch.Generator, masses: torch.Tensor, temp_k: float,
                    amask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Maxwell-Boltzmann velocities with COM drift removed.

    The normal draws come from ``gen`` (on its own device, the CPU for a
    default generator) and are moved to ``masses.device``, so a seed gives
    the same velocities on any device. They differ from the reference's
    threefry draws for the same seed.
    """
    n = masses.shape[0]
    # sigma^2 = kB T / m in (A/fs)^2: E[eV]/m[amu] converts with FORCE_TO_ACC.
    sigma = torch.sqrt(KB_EV * temp_k / masses * FORCE_TO_ACC)
    noise = torch.randn((n, 3), generator=gen, dtype=masses.dtype)
    v = noise.to(masses.device) * sigma[:, None]
    w = _weights(n, masses, amask)[:, None]
    mom = torch.sum(v * masses[:, None] * w, dim=0)
    mtot = torch.sum(masses * w[:, 0])
    return (v - mom / mtot) * w


def kinetic_energy(vel: torch.Tensor, masses: torch.Tensor,
                   amask: Optional[torch.Tensor] = None) -> torch.Tensor:
    w = _weights(vel.shape[0], vel, amask)
    ke = 0.5 * torch.sum(masses * w * torch.sum(vel * vel, dim=-1))
    return ke / FORCE_TO_ACC                      # back to eV


def temperature(vel: torch.Tensor, masses: torch.Tensor,
                amask: Optional[torch.Tensor] = None) -> torch.Tensor:
    w = _weights(vel.shape[0], vel, amask)
    ndof = 3.0 * torch.clamp(torch.sum(w), min=1.0)
    return 2.0 * kinetic_energy(vel, masses, amask) / (ndof * KB_EV)


def kinetic_tensor(vel: torch.Tensor, masses: torch.Tensor,
                   amask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(3, 3) kinetic stress contribution sum_i m_i v_i (x) v_i in eV.

    Its trace is 2x the kinetic energy; together with the configurational
    virial W it forms the instantaneous stress sigma = (K + W) / V.
    """
    w = _weights(vel.shape[0], vel, amask)
    mv = (masses * w)[:, None] * vel
    return torch.einsum("ia,ib->ab", mv, vel) / FORCE_TO_ACC


def stress_tensor(kin: torch.Tensor, virial: torch.Tensor,
                  volume: torch.Tensor) -> torch.Tensor:
    """Instantaneous stress sigma = (sum m v(x)v + W) / V in eV/A^3.

    Sign convention: positive pressure = compression (trace(sigma)/3 is the
    instantaneous pressure of the usual virial theorem)."""
    return (kin + virial) / volume


def pressure_of(stress: torch.Tensor) -> torch.Tensor:
    """Scalar instantaneous pressure P = trace(sigma) / 3 (eV/A^3)."""
    return torch.trace(stress) / 3.0


def volume_of(box: torch.Tensor) -> torch.Tensor:
    """Orthorhombic box volume (A^3) from edge lengths (3,)."""
    return torch.prod(box)


def verlet_half_kick(vel, force, masses, dt):
    return vel + 0.5 * dt * FORCE_TO_ACC * force / masses[:, None]


def verlet_drift(pos, vel, dt, box: Optional[torch.Tensor] = None):
    pos = pos + dt * vel
    if box is not None:
        pos = torch.remainder(pos, box)
    return pos
