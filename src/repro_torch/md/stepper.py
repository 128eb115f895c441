"""Segment stepping engine: the MD inner loop between neighbor rebuilds.

The counterpart of ``repro.md.stepper``'s segment engine. Where the
reference scans a jitted step over a ``rebuild_every``-step segment, this
engine runs the step in a Python loop under ``torch.no_grad()``; the
per-step thermo stays on the device, stacked, and the host fetches it ONCE
per segment (:func:`fetch_thermo`). Neighbor overflow is checked at segment
boundaries with a capacity-escalation retry: capacities grow geometrically
and the list is rebuilt from the same, still valid, positions. The
descriptor normalization stays pinned to the model's native ``cfg.nsel``
(``nsel_norm``), so escalated capacities change padding, never physics.

No barostat: the box is carried but never moves (ROADMAP.md §A.10).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.types import DPConfig
from repro_torch.md import api, integrator, neighbors


def segment_schedule(steps: int, rebuild_every: int) -> List[int]:
    """Split ``steps`` into segment lengths at neighbor-rebuild cadence.

    Full ``rebuild_every``-length segments followed by one trailing partial
    segment; the rebuild happens between entries.
    """
    if steps < 0 or rebuild_every <= 0:
        raise ValueError(f"bad schedule: steps={steps} rebuild={rebuild_every}")
    sched = [rebuild_every] * (steps // rebuild_every)
    if steps % rebuild_every:
        sched.append(steps % rebuild_every)
    return sched


class SegmentEngine:
    """Runs ``step_fn(carry, *aux) -> (carry, per_step_out)`` for ``n_steps``.

    The loop runs under ``torch.no_grad()`` (forces take their own graph
    inside the potential, so no graph survives a step). Per-step outputs
    come back stacked on the device with a leading ``(n_steps,)`` dim;
    nothing in the loop waits for the device.
    """

    def __init__(self, step_fn: Callable):
        self._step_fn = step_fn

    def run(self, carry: Any, n_steps: int, *aux: Any):
        outs = []
        with torch.no_grad():
            for _ in range(n_steps):
                carry, out = self._step_fn(carry, *aux)
                outs.append(out)
        return carry, {k: torch.stack([o[k] for o in outs]) for k in outs[0]}


def fetch_thermo(th: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Copy a segment's stacked thermo to the host in ONE transfer."""
    keys = list(th)
    n = th[keys[0]].shape[0]
    flat = torch.cat([th[k].reshape(n, -1).to(torch.float32) for k in keys],
                     dim=1).cpu().numpy()
    out, col = {}, 0
    for k in keys:
        width = int(np.prod(th[k].shape[1:]))
        out[k] = flat[:, col:col + width].reshape(th[k].shape)
        col += width
    return out


# ------------------------------------------------- capacity escalation policy

@dataclasses.dataclass(frozen=True)
class EscalationPolicy:
    """Geometric capacity growth on neighbor overflow (checked per segment)."""
    growth: float = 1.6
    max_attempts: int = 6
    round_to: int = 8

    def grow(self, n: int) -> int:
        """Grow ``n`` by ``growth``, rounded up to a multiple of ``round_to``.

        (The reference also folds a box-volume ratio in here; that comes
        with the barostats, ROADMAP.md §A.10.)
        """
        n_new = max(int(n * self.growth), n + 1)
        return -(-n_new // self.round_to) * self.round_to


class NeighborBuild(NamedTuple):
    nlist: torch.Tensor
    cfg_run: DPConfig             # cfg with sel matching the nlist layout
    spec: neighbors.NeighborSpec  # possibly escalated
    escalations: int
    overflow: int = 0             # worst flag seen across build attempts
    #                               (> 0 iff escalation fired; <= 0: slack)


def grid_key_for(spec: neighbors.NeighborSpec,
                 box: np.ndarray) -> Tuple[int, ...]:
    """The static cell-grid signature of ``box``: cells per dimension."""
    return tuple(int(n) for n in np.maximum(
        np.floor(np.asarray(box, float) / spec.rcut_nbr).astype(int), 1))


def _dyn_cell_list_fn(spec: neighbors.NeighborSpec, grid_key: Tuple[int, ...]):
    """Dynamic-box neighbor fn for the cell grid ``grid_key``.

    The reference box is ``(k + 0.5) * rcut_nbr``: ``k * rcut_nbr`` can
    floor back to ``k - 1`` in float and build a different grid than the
    key claims.
    """
    ref_box = (np.asarray(grid_key, float) + 0.5) * spec.rcut_nbr
    return neighbors.make_cell_list_fn(spec, ref_box, dynamic_box=True)


def build_neighbors_escalating(
    cfg: DPConfig, spec: neighbors.NeighborSpec, box: np.ndarray,
    pos: torch.Tensor, typ: torch.Tensor,
    policy: Optional[EscalationPolicy] = None,
) -> NeighborBuild:
    """Build the neighbor list; on overflow escalate capacities and retry.

    This is the host sync of a segment boundary: the overflow flag of the
    fresh list decides escalation. Escalation grows every type-section
    capacity and the cell-bin capacity, then rebuilds from the same
    positions. The returned ``cfg_run`` carries the escalated ``sel``;
    callers evaluate it with ``nsel_norm=cfg.nsel``. The cell grid is
    derived from ``box`` on every call (the reference's ``dynamic_box``
    form).
    """
    policy = policy or EscalationPolicy()
    box_np = np.asarray(box, float).reshape(-1)
    box_t = torch.as_tensor(box_np, dtype=torch.float32, device=pos.device)
    escalations = 0
    worst = None
    for _ in range(policy.max_attempts):
        fn = _dyn_cell_list_fn(spec, grid_key_for(spec, box_np))
        nlist, ovf = fn(pos, typ, box_t)
        ovf = int(ovf)
        worst = ovf if worst is None else max(worst, ovf)
        if ovf <= 0:
            cfg_run = (cfg if tuple(spec.sel) == tuple(cfg.sel)
                       else dataclasses.replace(cfg, sel=tuple(spec.sel)))
            return NeighborBuild(nlist, cfg_run, spec, escalations, worst)
        spec = dataclasses.replace(
            spec, sel=tuple(policy.grow(s) for s in spec.sel),
            cell_capacity=policy.grow(spec.cell_capacity))
        escalations += 1
    raise RuntimeError(
        f"neighbor capacity overflow persists after {policy.max_attempts} "
        f"escalations (last spec: sel={spec.sel}, "
        f"cell_capacity={spec.cell_capacity})")


# --------------------------------------------- single-process MD step

class MDCarry(NamedTuple):
    """State carried from step to step.

    ``ens`` is the ensemble's extra state (empty for NVE); ``box`` the (3,)
    box, which stays fixed (no barostat is ported, ROADMAP.md §A.10).
    """
    pos: torch.Tensor     # (N, 3) A
    vel: torch.Tensor     # (N, 3) A/fs
    force: torch.Tensor   # (N, 3) eV/A
    ens: Any
    box: torch.Tensor     # (3,) A


def make_md_step(potential: api.Potential,
                 ensemble: api.Ensemble) -> Callable:
    """One kick-drift-(force)-kick step of ``ensemble`` under ``potential``.

    ``(MDCarry, params, nlist, typ, masses, dt) -> (MDCarry, thermo)``; the
    thermo holds pe/ke plus the pressure observables (stress tensor (3, 3)
    eV/A^3, scalar pressure, volume) from the potential's virial.
    """

    def md_step(carry: MDCarry, params, nlist, typ, masses, dt):
        pos, vel, f, ens, box = carry
        vel = ensemble.half_kick(vel, f, masses, dt)
        pos = ensemble.drift(pos, vel, dt, box)
        e, f_new, stats = potential.energy_forces(params, pos, typ, nlist,
                                                  box=box)
        vel = ensemble.half_kick(vel, f_new, masses, dt)
        vel, ens = ensemble.finalize(vel, masses, dt, ens)
        ke = integrator.kinetic_energy(vel, masses)
        vol = integrator.volume_of(box)
        stress = integrator.stress_tensor(
            integrator.kinetic_tensor(vel, masses), stats["virial"], vol)
        thermo = {"pe": e, "ke": ke, "stress": stress,
                  "press": integrator.pressure_of(stress), "vol": vol}
        return MDCarry(pos, vel, f_new, ens, box), thermo

    return md_step


def md_segment_engine(potential: api.Potential,
                      ensemble: api.Ensemble) -> SegmentEngine:
    """Engine whose step is one full kick-drift-(force)-kick MD step."""
    return SegmentEngine(make_md_step(potential, ensemble))


def box_lengths(box) -> np.ndarray:
    """Host-side (3,) orthorhombic edge lengths from a box spelling.

    Accepts a length-3 vector or a DIAGONAL (3, 3) matrix; anything else
    (triclinic cells, wrong sizes) raises instead of silently truncating.
    """
    a = np.asarray(box, np.float64).reshape(-1)
    if a.size == 9:
        m = a.reshape(3, 3)
        if np.any(m != np.diag(np.diag(m))):
            raise ValueError(f"non-orthorhombic box not supported: {m}")
        a = np.diag(m)
    if a.size != 3:
        raise ValueError(f"box must be (3,) edge lengths or a diagonal "
                         f"(3, 3) matrix, got shape {np.shape(box)}")
    return a


def pack_box(box, device: torch.device) -> torch.Tensor:
    """The (3,) float32 box carry entry from a host box spelling."""
    return torch.as_tensor(box_lengths(box), dtype=torch.float32,
                           device=device)


def thermo_rows(pe: np.ndarray, ke: np.ndarray, step_base: int, steps: int,
                thermo_every: int, n_atoms: int,
                press: Optional[np.ndarray] = None,
                vol: Optional[np.ndarray] = None) -> List[Dict[str, float]]:
    """Host-side selection of thermo rows from a segment's stacked PE/KE.

    Every ``thermo_every`` global steps plus the final step. Temperature
    follows from KE and 3N degrees of freedom; with the stacked pressure and
    volume each row gains ``press_gpa`` (GPa) and ``vol`` (A^3) columns.
    """
    rows = []
    ndof = 3.0 * max(n_atoms, 1)
    for i in range(len(pe)):
        gstep = step_base + i + 1
        if gstep % thermo_every == 0 or gstep == steps:
            row = {
                "step": gstep, "pe": float(pe[i]), "ke": float(ke[i]),
                "etot": float(pe[i]) + float(ke[i]),
                "temp": 2.0 * float(ke[i]) / (ndof * integrator.KB_EV),
            }
            if press is not None:
                row["press_gpa"] = float(press[i]) * integrator.EV_A3_TO_GPA
            if vol is not None:
                row["vol"] = float(vol[i])
            rows.append(row)
    return rows
