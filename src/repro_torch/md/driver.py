"""Single-process MD driver reproducing the paper's protocol (Sec. 4).

The run is described by a :class:`repro_torch.md.api.SimulationSpec` — a
``Potential``, an ``Ensemble``, an optional ``Barostat`` and the protocol
scalars — and executed by :func:`run_simulation` (what
``api.Simulation.run`` calls). The default protocol is the paper's:
Velocity-Verlet NVE, Maxwell-Boltzmann init at 330 K, neighbor list with a
2 A buffer rebuilt every 50 steps, thermo recorded every 50 steps; 99 steps
=> energy and forces evaluated 100 times.

Three stepping engines share this entry point, as in the reference:

  engine="outer"  the outer engine (``md/stepper.py`` ``OuterEngine``): the
                  neighbor rebuild runs on the device inside each segment,
                  and on the card each segment is a captured CUDA graph,
                  replayed. One host sync per *chunk* of segments.
  engine="scan"   (default) the segment engine: a step loop per rebuild
                  segment, a host rebuild before each, thermo fetched once
                  per segment.
  engine="python" the per-step loop, kept as the trajectory reference.

The scan and outer engines share one loop over stretches of steps (a
segment or a chunk, :func:`_run_chunks`); ``stepper.Capacities`` holds the
run's capacities and decides after each stretch whether it runs again.

The engines agree on the physics: within the skin buffer every pair inside
rcut is in both lists and pairs beyond rcut contribute exactly zero.

``run_md`` remains as a DEPRECATED thin shim over the spec API.

Each call is one ``md.call`` root of the span recorder (``repro_torch.obs``),
with ``model.first_force``, ``driver.loop`` and ``md.result`` inside it and
each engine's own spans inside the loop; ``wall_s`` is the loop span's
duration.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.types import DPConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.md import api, integrator, lattice, neighbors, stepper


@dataclasses.dataclass
class MDResult:
    thermo: List[Dict[str, float]]
    final_pos: np.ndarray
    final_vel: np.ndarray
    wall_s: float                 # the stepping loop (the driver.loop span)
    steps: int
    n_atoms: int
    engine: str = "scan"
    escalations: int = 0          # neighbor capacity escalations taken
    host_syncs: int = 0           # device->host round-trips in the hot loop
    overflow_checks: int = 0      # neighbor-overflow flags inspected
    overflow_worst: int = 0       # worst flag seen (<= 0: slot slack left)
    final_box: Optional[np.ndarray] = None   # (3,) A — moves under a barostat
    stress: Optional[np.ndarray] = None      # (steps, 3, 3) eV/A^3 per-step
    grid_rebuilds: int = 0        # cell grids re-derived from a moved box
    sel: Tuple[int, ...] = ()     # neighbor slot layout at the end of the run
    graph_captures: int = 0       # outer engine on the card: CUDA graphs
    graph_replays: int = 0        # captured, and replays of them
    capture_s: float = 0.0        # part of wall_s spent warming up + capturing
    # a potential's own section at the end (a tuple for several; 0: none),
    # escalations of it in escalations
    section_slots: Union[int, Tuple[int, ...]] = 0

    @property
    def us_per_step_atom(self) -> float:
        return self.wall_s * 1e6 / (self.steps * self.n_atoms)

    def press_gpa_trace(self) -> np.ndarray:
        """Per-recorded-row instantaneous pressure (GPa) convenience."""
        return np.asarray([row.get("press_gpa", np.nan)
                           for row in self.thermo])


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _to_host(*tensors: torch.Tensor) -> List[np.ndarray]:
    """The final state's copies to the host."""
    with obs.span("md.result"):
        return [t.cpu().numpy() for t in tensors]


def run_md(cfg: Optional[DPConfig], params: Any, pos: np.ndarray,
           typ: np.ndarray, box: np.ndarray, *, steps: int = 99,
           dt_fs: float = 1.0, temp_k: float = 330.0, rebuild_every: int = 50,
           thermo_every: int = 50, skin: float = 2.0,
           impl: Optional[str] = None, seed: int = 0,
           engine: str = "scan", chunk_segments: int = 8,
           escalation: Optional[stepper.EscalationPolicy] = None,
           potential: Optional[api.Potential] = None,
           ensemble: Optional[api.Ensemble] = None,
           barostat: Optional[api.Barostat] = None,
           device: DeviceLike = "cuda") -> MDResult:
    """DEPRECATED kwarg-pile entry point; thin shim over the spec API.

    Build an :class:`api.SimulationSpec` and call ``api.Simulation.run``
    instead. The shim constructs exactly that spec (a ``DPPotential``
    pinned to ``cfg.nsel`` + NVE unless ``potential``/``ensemble``
    override), so trajectories are bit-identical between the two entry
    points on the CPU.
    """
    spec = api.SimulationSpec(
        potential=potential or api.DPPotential(cfg, impl=impl,
                                               nsel_norm=cfg.nsel),
        ensemble=ensemble or api.NVE(),
        steps=steps, dt_fs=dt_fs, temp_k=temp_k,
        rebuild_every=rebuild_every, thermo_every=thermo_every, skin=skin,
        seed=seed, engine=engine, chunk_segments=chunk_segments,
        escalation=escalation, barostat=barostat)
    return run_simulation(spec, params, pos, typ, box, device=device)


def run_simulation(spec: api.SimulationSpec, params: Any, pos: np.ndarray,
                   typ: np.ndarray, box: np.ndarray,
                   device: DeviceLike = "cuda") -> MDResult:
    """Run ``spec`` on ``(params, pos, typ, box)`` — the one MD entry point.

    ``params`` must already live on ``device`` (see ``bridge`` and
    ``init_dp_params``). ``wall_s`` covers the stepping loop, rebuilds
    included, and ends after the device has finished.
    """
    if spec.engine not in ("outer", "scan", "python"):
        raise ValueError(f"unknown engine {spec.engine!r}")
    with obs.root("md.call", engine=spec.engine, steps=spec.steps,
                  atoms=len(pos)):
        return _simulate(spec, params, pos, typ, box, resolve_device(device))


def _simulate(spec: api.SimulationSpec, params: Any, pos: np.ndarray,
              typ: np.ndarray, box: np.ndarray,
              dev: torch.device) -> MDResult:
    pot, ens_obj, baro = spec.potential, spec.ensemble, spec.barostat
    masses = torch.as_tensor(lattice.masses_for(pot.type_map, np.asarray(typ)),
                             dtype=torch.float32, device=dev)
    nspec = neighbors.NeighborSpec(rcut_nbr=pot.rcut + spec.skin,
                                   sel=pot.sel)
    box_np = stepper.box_lengths(box)

    pos = torch.as_tensor(np.asarray(pos), dtype=torch.float32, device=dev)
    typ = torch.as_tensor(np.asarray(typ), dtype=torch.int64, device=dev)
    boxt = stepper.pack_box(box_np, dev)   # the dynamic box: rides in the carry
    gen = torch.Generator().manual_seed(spec.seed)
    vel = torch.as_tensor(integrator.init_velocities(gen, masses, spec.temp_k),
                          dtype=torch.float32, device=dev)
    ens = ens_obj.init_state(dev)
    baro_state = baro.init_state(dev) if baro is not None else ()

    if spec.engine == "python":
        return _run_md_python(pot, ens_obj, params, pos, vel, typ, boxt,
                              box_np, masses, nspec, ens, baro_state, dev,
                              steps=spec.steps, dt_fs=spec.dt_fs,
                              rebuild_every=spec.rebuild_every,
                              thermo_every=spec.thermo_every, barostat=baro)

    # ------------------------------------------ device paths (scan / outer)
    caps = stepper.Capacities(pot, nspec, box_np, spec.escalation,
                              moving_box=baro is not None)
    nlist, pot_run = caps.host_build(pos, typ, boxt)
    with obs.span("model.first_force"):
        _, f, _ = pot_run.energy_forces(params, pos, typ, nlist, box=boxt)
        _sync(dev)
    aux = (params, typ, masses, spec.dt_fs)
    if spec.engine == "outer":
        carry = stepper.OuterCarry(
            pos, vel, f, torch.zeros((), dtype=torch.int32, device=dev), ens,
            boxt, baro_state)
        stretch = _OuterChunks(caps, ens_obj, baro, aux, spec.chunk_segments)
    else:
        carry = stepper.MDCarry(pos, vel, f, ens, boxt, baro_state)
        stretch = _ScanSegments(caps, ens_obj, baro, aux, nlist=nlist)
    return _run_chunks(stretch, carry, dev, steps=spec.steps,
                       rebuild_every=spec.rebuild_every,
                       thermo_every=spec.thermo_every)


class _Stretch:
    """An engine's steps between two fetches of the host: ``run`` gives the
    carry after ``n_segs`` segments of ``seg_len`` steps and their thermo."""

    def __init__(self, caps: stepper.Capacities, ens_obj: api.Ensemble,
                 baro: Optional[api.Barostat], aux: Tuple[Any, ...],
                 chunk_segments: int = 1,
                 nlist: Optional[torch.Tensor] = None):
        self.caps, self.ens_obj, self.baro, self.aux = caps, ens_obj, baro, aux
        self.nlist, self.chunk_segments = nlist, chunk_segments
        self.engines: Dict[Tuple[Any, ...], stepper.OuterEngine] = {}

    def boundary(self, carry) -> None:
        """Before each stretch but the first."""

    def restore(self, snap: stepper.Snapshot):
        return stepper.restore(snap)


class _ScanSegments(_Stretch):
    """A segment of the scan engine, its list built on the host."""

    where, engine = "segment", "scan"

    def boundary(self, carry: stepper.MDCarry) -> None:
        self.nlist, _ = self.caps.host_build(carry.pos, self.aux[1], carry.box)

    def run(self, carry, attempt: int, n_segs: int, seg_len: int):
        eng = stepper.md_segment_engine(self.caps.run_potential, self.ens_obj,
                                        self.baro)
        params, typ, masses, dt = self.aux
        with obs.span("driver.segment", steps=seg_len):
            carry, th = eng.run(carry, seg_len, params, self.nlist, typ,
                                masses, dt)
        with obs.span("driver.fetch"):      # ONE device->host sync a segment
            return carry, stepper.fetch_thermo(th)


class _OuterChunks(_Stretch):
    """A chunk of the outer engine's segments, its lists built on the
    device; one engine a layout (on the card, one capture a length)."""

    where, engine = "chunk", "outer"

    def run(self, carry, attempt: int, n_segs: int, seg_len: int):
        caps = self.caps
        with obs.span("outer.chunk", attempt=attempt, segments=n_segs):
            key = (caps.spec, caps.grid_key, caps.potential)
            if key not in self.engines:
                self.engines[key] = stepper.md_outer_engine(
                    caps.run_potential, self.ens_obj, caps.spec,
                    caps.grid_key, self.baro)
            out, th = self.engines[key].run(carry, n_segs, seg_len, *self.aux)
            th["overflow"] = out.overflow.reshape(1).expand(n_segs)
            th["box"] = out.box.reshape(1, 3).expand(n_segs, 3)
            with obs.span("outer.fetch"):
                return out, stepper.fetch_thermo(th)

    def restore(self, snap: stepper.Snapshot):
        with obs.span("outer.restore"):
            return stepper.restore(snap)


def _run_chunks(stretch: _Stretch, carry, dev: torch.device, *, steps: int,
                rebuild_every: int, thermo_every: int) -> MDResult:
    """The scan and outer engines' loop over stretches (``chunk_schedule``):
    each runs, fetches its thermo once and, while ``caps.regrow`` says so,
    runs again from a snapshot (taken where ``caps.can_regrow``; it holds
    the generators' states, so a replay draws the same noise)."""
    n, caps = carry.pos.shape[0], stretch.caps
    replayable = caps.can_regrow(stretch.where)
    thermo: List[Dict[str, float]] = []
    stress: List[np.ndarray] = []
    with obs.timed("driver.loop") as loop:
        step_base = 0
        for n_segs, seg_len in stepper.chunk_schedule(
                steps, rebuild_every, stretch.chunk_segments):
            if step_base > 0:
                stretch.boundary(carry)
            for attempt in range(caps.policy.max_attempts + 1):
                snap = stepper.snapshot(carry) if replayable else None
                out, host = stretch.run(carry, attempt, n_segs, seg_len)
                if not caps.regrow(host, stretch.where):
                    carry = out
                    break
                carry = stretch.restore(snap)
            else:
                raise caps.give_up(stretch.where)
            thermo.extend(stepper.thermo_rows(
                host["pe"].reshape(-1), host["ke"].reshape(-1), step_base,
                steps, thermo_every, n, press=host["press"].reshape(-1),
                vol=host["vol"].reshape(-1)))
            stress.append(host["stress"].reshape(-1, 3, 3))
            step_base += n_segs * seg_len
        _sync(dev)
    final_pos, final_vel, final_box = _to_host(carry.pos, carry.vel, carry.box)
    engines = stretch.engines.values()
    return MDResult(thermo=thermo, final_pos=final_pos, final_vel=final_vel,
                    wall_s=loop.seconds, steps=steps, n_atoms=n,
                    engine=stretch.engine, final_box=final_box,
                    stress=np.concatenate(stress) if stress else None,
                    graph_captures=sum(e.captures for e in engines),
                    graph_replays=sum(e.replays for e in engines),
                    capture_s=sum(e.capture_ns for e in engines) * 1e-9,
                    **caps.counters())


def _run_md_outer(pot: api.Potential, ens_obj: api.Ensemble, params,
                  carry: stepper.OuterCarry, typ, box_np, masses,
                  build: stepper.NeighborBuild, dev: torch.device, *, steps,
                  dt_fs, rebuild_every, thermo_every, chunk_segments,
                  escalation, barostat: Optional[api.Barostat] = None):
    """The outer engine's chunks after a host ``build`` its caller made,
    ``carry`` holding its forces (regrow: ``stepper.Capacities``)."""
    caps = stepper.Capacities(pot, build.spec, box_np, escalation)
    caps.accept(build)
    stretch = _OuterChunks(caps, ens_obj, barostat,
                           (params, typ, masses, dt_fs), chunk_segments)
    return _run_chunks(stretch, carry, dev, steps=steps,
                       rebuild_every=rebuild_every, thermo_every=thermo_every)


def _run_md_python(pot: api.Potential, ens_obj: api.Ensemble, params, pos,
                   vel, typ, boxt, box_np, masses, nspec, ens, baro,
                   dev: torch.device, *, steps, dt_fs, rebuild_every,
                   thermo_every, barostat: Optional[api.Barostat] = None):
    """The per-step loop (trajectory reference / baseline).

    The rebuild's overflow flags stay on the device and are checked once
    after the run; ``host_syncs`` counts the real round-trips (initial
    build + each thermo row's fetch + each barostat box fetch + the
    deferred check), as the reference counts them. Under a barostat the
    neighbor search takes the carried box, and the grid is re-derived from
    the host copy when the cell counts change.
    """
    grid_key = stepper.grid_key_for(nspec, box_np)
    nbr_fn = stepper._dyn_cell_list_fn(nspec, grid_key)

    with torch.no_grad():
        nlist, ovf = nbr_fn(pos, typ, boxt)
    host_syncs = 1
    overflow_worst = int(ovf)
    if overflow_worst > 0:
        raise RuntimeError(f"neighbor overflow {overflow_worst} at init")
    with obs.span("model.first_force"):
        e, f, stats = pot.energy_forces(params, pos, typ, nlist, box=boxt)
        _sync(dev)

    thermo: List[Dict[str, float]] = []
    stress_steps = []
    # a potential's own section is checked with the lists' flags, after
    # the run (this loop has no replay)
    ovf_flags = [stats[api.MODEL_EXCESS].max()] \
        if api.MODEL_EXCESS in stats else []
    grid_rebuilds = 0
    with obs.timed("driver.loop") as loop, torch.no_grad():
        for step in range(steps):
            vel = ens_obj.half_kick(vel, f, masses, dt_fs)
            pos = ens_obj.drift(pos, vel, dt_fs, boxt)
            if (step + 1) % rebuild_every == 0:
                if barostat is not None:
                    # the grid follows the barostat-moved box (a fixed box
                    # is never fetched)
                    box_host = boxt.cpu().numpy().astype(float)
                    host_syncs += 1
                    key_now = stepper.grid_key_for(nspec, box_host)
                    if key_now != grid_key:
                        grid_key = key_now
                        grid_rebuilds += 1
                        nbr_fn = stepper._dyn_cell_list_fn(nspec, key_now)
                nlist, ovf = nbr_fn(pos, typ, boxt)
                ovf_flags.append(ovf)       # device scalar; no sync here
            e, f_new, stats = pot.energy_forces(params, pos, typ, nlist,
                                                box=boxt)
            if api.MODEL_EXCESS in stats:
                ovf_flags.append(stats[api.MODEL_EXCESS].max())
            vel = ens_obj.half_kick(vel, f_new, masses, dt_fs)
            vel, ens = ens_obj.finalize(vel, masses, dt_fs, ens)
            f = f_new
            vol = integrator.volume_of(boxt)
            stress = integrator.stress_tensor(
                integrator.kinetic_tensor(vel, masses), stats["virial"], vol)
            stress_steps.append(stress)     # device value; no sync here
            # thermo snapshots PRE-barostat velocities/volume, the point in
            # the step the other engines record
            if (step + 1) % thermo_every == 0 or step == steps - 1:
                ke = integrator.kinetic_energy(vel, masses)
                row = torch.stack([
                    e, ke, integrator.temperature(vel, masses),
                    integrator.pressure_of(stress), vol]).cpu().tolist()
                host_syncs += 1             # the thermo fetch
                thermo.append({
                    "step": step + 1, "pe": row[0], "ke": row[1],
                    "etot": row[0] + row[1], "temp": row[2],
                    "press_gpa": row[3] * integrator.EV_A3_TO_GPA,
                    "vol": row[4]})
            if barostat is not None:
                boxt, pos, vel, baro = barostat.apply(boxt, pos, vel, stress,
                                                      baro, dt_fs)
        _sync(dev)
    if ovf_flags:
        # ONE deferred fetch inspects every rebuild's flag after the run
        worst = int(torch.stack(ovf_flags).max())
        host_syncs += 1
        overflow_worst = max(overflow_worst, worst)
        if worst > 0:
            raise RuntimeError(f"neighbor overflow {worst} during run")
    stress = [torch.stack(stress_steps)] if stress_steps else []
    final_pos, final_vel, final_box, *stress = _to_host(pos, vel, boxt,
                                                        *stress)
    return MDResult(thermo=thermo, final_pos=final_pos,
                    final_vel=final_vel, wall_s=loop.seconds, steps=steps,
                    n_atoms=pos.shape[0], engine="python",
                    host_syncs=host_syncs,
                    overflow_checks=len(ovf_flags) + 1,
                    overflow_worst=overflow_worst,
                    final_box=final_box,
                    stress=stress[0] if stress else None,
                    grid_rebuilds=grid_rebuilds, sel=tuple(nspec.sel))
