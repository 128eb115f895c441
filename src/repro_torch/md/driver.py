"""Single-process MD driver reproducing the paper's protocol (Sec. 4).

The run is described by a :class:`repro_torch.md.api.SimulationSpec` — a
``Potential``, an ``Ensemble`` and the protocol scalars — and executed by
:func:`run_simulation` (what ``api.Simulation.run`` calls). The default
protocol is the paper's: Velocity-Verlet NVE, Maxwell-Boltzmann init at
330 K, neighbor list with a 2 A buffer rebuilt every 50 steps, thermo
recorded every 50 steps; 99 steps => energy and forces evaluated 100 times.

One stepping engine is ported, ``engine="scan"``: the segment engine of
``md/stepper.py``, with the thermo fetched once per segment and the
neighbor overflow checked at segment boundaries (host rebuild) with
capacity escalation. The python and outer engines are not ported yet
(ROADMAP.md §A.8).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.md import api, integrator, lattice, neighbors, stepper


@dataclasses.dataclass
class MDResult:
    thermo: List[Dict[str, float]]
    final_pos: np.ndarray
    final_vel: np.ndarray
    wall_s: float
    steps: int
    n_atoms: int
    engine: str = "scan"
    escalations: int = 0          # neighbor capacity escalations taken
    host_syncs: int = 0           # device->host round-trips in the hot loop
    overflow_checks: int = 0      # neighbor-overflow flags inspected
    overflow_worst: int = 0       # worst flag seen (<= 0: slot slack left)
    final_box: Optional[np.ndarray] = None   # (3,) A
    stress: Optional[np.ndarray] = None      # (steps, 3, 3) eV/A^3 per-step
    sel: Tuple[int, ...] = ()     # neighbor slot layout at the end of the run

    @property
    def us_per_step_atom(self) -> float:
        return self.wall_s * 1e6 / (self.steps * self.n_atoms)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_simulation(spec: api.SimulationSpec, params: Any, pos: np.ndarray,
                   typ: np.ndarray, box: np.ndarray,
                   device: DeviceLike = "cuda") -> MDResult:
    """Run ``spec`` on ``(params, pos, typ, box)`` — the one MD entry point.

    ``params`` must already live on ``device`` (see ``bridge`` and
    ``init_dp_params``). ``wall_s`` covers the stepping loop, rebuilds
    included, and ends after the device has finished.
    """
    if spec.engine in ("python", "outer"):
        raise NotImplementedError(
            f"engine={spec.engine!r} is not ported yet (ROADMAP.md §A.8)")
    if spec.engine != "scan":
        raise ValueError(f"unknown engine {spec.engine!r}")
    dev = resolve_device(device)
    pot, ens_obj = spec.potential, spec.ensemble
    n = len(pos)
    masses = torch.as_tensor(lattice.masses_for(pot.type_map, np.asarray(typ)),
                             dtype=torch.float32, device=dev)
    nspec = neighbors.NeighborSpec(rcut_nbr=pot.rcut + spec.skin,
                                   sel=pot.sel)
    box_np = stepper.box_lengths(box)

    pos = torch.as_tensor(np.asarray(pos), dtype=torch.float32, device=dev)
    typ = torch.as_tensor(np.asarray(typ), dtype=torch.int64, device=dev)
    boxt = stepper.pack_box(box_np, dev)
    gen = torch.Generator().manual_seed(spec.seed)
    vel = torch.as_tensor(integrator.init_velocities(gen, masses, spec.temp_k),
                          dtype=torch.float32, device=dev)

    build = stepper.build_neighbors_escalating(
        pot.layout_cfg(), nspec, box_np, pos, typ, spec.escalation)
    escalations = build.escalations
    overflow_checks = build.escalations + 1
    overflow_worst = build.overflow
    pot_run = pot.with_layout(build.spec.sel)
    _, f, _ = pot_run.energy_forces(params, pos, typ, build.nlist, box=boxt)

    eng = stepper.md_segment_engine(pot_run, ens_obj)
    carry = stepper.MDCarry(pos, vel, f, ens_obj.init_state(), boxt)

    thermo: List[Dict[str, float]] = []
    stress_segs: List[np.ndarray] = []
    host_syncs = 1                      # initial build's overflow check
    _sync(dev)
    t0 = time.perf_counter()
    step_base = 0
    for seg_len in stepper.segment_schedule(spec.steps, spec.rebuild_every):
        if step_base > 0:
            # segment boundary: rebuild at the current positions; the
            # overflow check + escalation retry lives inside (one host sync
            # per segment). The box never moves without a barostat.
            build = stepper.build_neighbors_escalating(
                pot.layout_cfg(), build.spec, box_np, carry.pos, typ,
                spec.escalation)
            host_syncs += 1
            overflow_checks += build.escalations + 1
            overflow_worst = max(overflow_worst, build.overflow)
            if build.escalations:
                escalations += build.escalations
                pot_run = pot.with_layout(build.spec.sel)
                eng = stepper.md_segment_engine(pot_run, ens_obj)
        carry, th = eng.run(carry, seg_len, params, build.nlist, typ,
                            masses, spec.dt_fs)
        # ONE device->host sync per segment fetches the stacked thermo
        th = stepper.fetch_thermo(th)
        thermo.extend(stepper.thermo_rows(
            th["pe"], th["ke"], step_base, spec.steps, spec.thermo_every, n,
            press=th["press"], vol=th["vol"]))
        stress_segs.append(th["stress"])
        host_syncs += 1
        step_base += seg_len
    _sync(dev)
    wall = time.perf_counter() - t0
    return MDResult(thermo=thermo, final_pos=carry.pos.cpu().numpy(),
                    final_vel=carry.vel.cpu().numpy(), wall_s=wall,
                    steps=spec.steps, n_atoms=n, engine="scan",
                    escalations=escalations, host_syncs=host_syncs,
                    overflow_checks=overflow_checks,
                    overflow_worst=overflow_worst,
                    final_box=carry.box.cpu().numpy(),
                    stress=(np.concatenate(stress_segs)
                            if stress_segs else None),
                    sel=tuple(build.spec.sel))
